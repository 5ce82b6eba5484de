"""Record the reference examples' output for tests/test_torch_examples.py.

Runs every ``examples/ex_*.py`` under JAX on the CPU in float64, as
``examples/run_all.sh`` does (``JAX_PLATFORMS=cpu``, from ``examples/``),
and writes ``tests/data/examples_reference.json``: for each example its
full stdout, its exit code (None when it ran past the timeout) and its
wall, with the commit it ran on. A failing example is recorded as it
failed.

Usage: python tests/make_examples_reference.py [--jobs 3] [--timeout 1200]
(10-20 min on an 8-core host: the GENMF and GRIDMF examples compile their
whole factorization).
"""
import argparse
import concurrent.futures
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
OUT = os.path.join(ROOT, "tests", "data", "examples_reference.json")


def run_one(path, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, os.path.basename(path)],
                             cwd=EXAMPLES, env=env, capture_output=True,
                             text=True, timeout=timeout)
        rc, out = res.returncode, res.stdout
    except subprocess.TimeoutExpired as exc:
        rc = None
        out = exc.stdout.decode() if isinstance(exc.stdout, bytes) else \
            (exc.stdout or "")
    return {"returncode": rc, "stdout": out,
            "seconds": round(time.perf_counter() - t0, 1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=1200.0)
    args = ap.parse_args()
    paths = sorted(glob.glob(os.path.join(EXAMPLES, "ex_*.py")))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    results = {}
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futs = {pool.submit(run_one, p, args.timeout): p for p in paths}
        for fut in concurrent.futures.as_completed(futs):
            name = os.path.basename(futs[fut])
            results[name] = fut.result()
            print(f"{name}: rc {results[name]['returncode']} "
                  f"{results[name]['seconds']} s", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump({"commit": commit, "platform": "cpu", "x64": True,
                   "examples": dict(sorted(results.items()))}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
