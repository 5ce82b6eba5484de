"""Run the port's examples in one process and record what each did.

Each ``examples_torch/ex_*.py`` runs through ``runpy`` with
``--device DEVICE``; for each the record holds its standard output, the
exception it raised (a traceback, or None), its wall and whether the
package's settings were the same after it as before it (``settings``:
the upper-case module constants of ``russell_tpu_torch``, such as
``factor.GRIDMF_BUDGET_GB``, torch's default dtype, thread counts and
the environment).

As a script it refuses ``jax``, ``jaxlib`` and ``russell_tpu`` at import,
runs on one intra-op thread, and writes the records as JSON:

    python examples_torch/_run.py --device cpu --out records.json
"""
import argparse
import contextlib
import glob
import importlib
import io
import json
import os
import pkgutil
import runpy
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFUSED = ("jax", "jaxlib", "russell_tpu")


class RefuseImports:
    """A ``sys.meta_path`` finder that makes importing any of ``names``
    (or a submodule of one) raise ImportError."""

    def __init__(self, names=REFUSED):
        self.names = tuple(names)

    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in self.names:
            raise ImportError(f"{fullname} is refused: the port's examples "
                              "import no JAX and nothing of russell_tpu")
        return None


def example_paths():
    return sorted(glob.glob(os.path.join(HERE, "ex_*.py")))


def import_package():
    """Import every module of russell_tpu_torch, so that a snapshot taken
    before an example sees every module's settings."""
    import russell_tpu_torch
    for info in pkgutil.walk_packages(russell_tpu_torch.__path__,
                                      "russell_tpu_torch."):
        importlib.import_module(info.name)


def settings():
    """The package's settings, each as its repr: every upper-case name of
    a loaded ``russell_tpu_torch`` module bound to a number, a string, a
    bool, None or a tuple, and torch's and the process's global state."""
    import torch
    snap = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != "russell_tpu_torch":
            continue
        for key, val in list(vars(mod).items()):
            if (key.isupper() and not key.startswith("_")
                    and isinstance(val, (int, float, str, bool, tuple,
                                         type(None)))):
                snap[f"{name}.{key}"] = repr(val)
    snap["torch.default_dtype"] = repr(torch.get_default_dtype())
    snap["torch.num_threads"] = repr(torch.get_num_threads())
    snap["torch.grad_enabled"] = repr(torch.is_grad_enabled())
    snap["torch.deterministic"] = repr(
        torch.are_deterministic_algorithms_enabled())
    snap["torch.matmul_tf32"] = repr(torch.backends.cuda.matmul.allow_tf32)
    # torch sets TORCHINDUCTOR_* itself when torch.func first loads inductor
    snap["os.environ"] = repr(sorted(
        kv for kv in os.environ.items()
        if not kv[0].startswith("TORCHINDUCTOR_")))
    return snap


def changed(before, after):
    """The settings that ``after`` lacks or holds with another value."""
    return sorted(k for k, v in before.items() if after.get(k) != v)


def run_one(path, device, catch=True):
    """Run one example: its record (name, stdout, error, wall_s,
    changed_settings). With ``catch=False`` an exception propagates."""
    argv = sys.argv
    before = settings()
    buf = io.StringIO()
    error = None
    t0 = time.perf_counter()
    try:
        sys.argv = [path, "--device", device]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except BaseException:                  # noqa: BLE001 (SystemExit too)
        if not catch:
            raise
        error = traceback.format_exc()
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    return {"name": os.path.basename(path), "stdout": buf.getvalue(),
            "error": error, "wall_s": wall,
            "changed_settings": changed(before, settings())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.meta_path.insert(0, RefuseImports())
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    import_package()
    records = [run_one(p, args.device) for p in example_paths()]
    bad = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    with open(args.out, "w") as fh:
        json.dump({"device": args.device, "records": records,
                   "refused_modules_loaded": bad}, fh, indent=1)


if __name__ == "__main__":
    main()
