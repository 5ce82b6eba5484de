"""Hold one run's standard output of an example to another's.

The lines must be the same with their numbers masked (whitespace is not
compared, so numpy's column padding may differ). Integers must be equal.
Floats must agree within ``1e-9 |ref| + 1e-12`` or half a unit of the
last printed digit, whichever is larger. The lines that print a duration
compare only their text before the value.

``EXCEPTIONS`` names the examples some of whose numbers cannot agree with
the reference package's, each with its reason and the lines concerned:
on these lines only the text with the numbers masked is compared, and
the example's own asserts carry the check. Lines that print a device's
text (``backend:``, ``devices:``, ``mesh:``) compare their label only.
It imports no torch, so that any harness can use it.
"""
import re

__all__ = ["EXCEPTIONS", "compare", "mask"]

REL_TOL = 1e-9
ABS_TOL = 1e-12

# name -> (reason, the lines compared with their numbers masked: a regex,
# or None for every line)
EXCEPTIONS = {
    "ex_stat_distributions.py": (
        "draws from a seeded torch.Generator, not jax.random keys: the "
        "sampled moments and the histogram counts differ", None),
    "ex_stat_frechet_quartiles.py": (
        "histogram of draws from a torch.Generator, not jax.random",
        r"^\["),
    "ex_stat_gumbel.py": (
        "sampled moments and histogram from a torch.Generator, not "
        "jax.random", r"^(\[|mean )"),
    "ex_stat_lognormal.py": (
        "sampled moments from a torch.Generator, not jax.random",
        r"^mean "),
    "ex_stat_normal.py": (
        "sampled moments and histogram from a torch.Generator, not "
        "jax.random", r"^(\[|sampled )"),
    "ex_stat_uniform.py": (
        "sampled extremes and mean from a torch.Generator, not jax.random",
        r"^sampled"),
    "ex_core_device_control.py": (
        "device counts: jax.devices() against the port's device rule",
        r"^device count:"),
    "ex_parallel_batch_mesh.py": (
        "the batch is 2 x the ranks: 8 faked host devices in the "
        "reference, a world of one process here", r"^(batch |solved )"),
    "ex_sparse_matrix_market_io.py": (
        "the reference reads bfwb62.mtx, which is not in the repository, "
        "and fails; the port writes and reads its own 62 x 62 band", None),
    # roundoff-sensitive outputs: the reference's own run with jit
    # disabled differs from its jitted run by as much as the port does
    "ex_ode_amplifier1t_dae.py": (
        "Radau5's last suggested step: 0.00077913 jitted, 0.00077915 "
        "with jit disabled", r"^Last accepted"),
    "ex_ode_pde_heat_spectral_mol.py": (
        "Radau5 at tolerance 1e-10: the last suggested step is 1.61397e-05 "
        "jitted, 1.61049e-05 with jit disabled, and on the card (cuBLAS's "
        "sums) the step counts move too (103 function evaluations against "
        "100 on the CPU)", None),
    "ex_ode_radau5_van_der_pol.py": (
        "Radau5's last suggested step: 0.151098712 jitted, 0.151098726 "
        "with jit disabled",
        r"^Last accepted"),
    "ex_ode_arenstorf_dopri8.py": (
        "y after the orbit: 9.51295232e-06 jitted, 9.51294674e-06 with "
        "jit disabled", r"^(y\(end\)|Last accepted)"),
    "ex_ode_simple_mass_system.py": (
        "the step counts: 857 function evaluations jitted, 860 with jit "
        "disabled (the port's count)", None),
    "ex_tensor_derivatives.py": (
        "a central-difference error at roundoff level (1e-11): its digits "
        "follow the device's last bits (1.22e-11 on the CPU, 1.05e-11 on "
        "the card)", r"^max \|dJ3"),
}
# lines whose value is a device's text compare only their label
DEVICE_TEXT = re.compile(r"^(\s*(?:backend|devices|mesh):)")

_NUMBER = re.compile(
    r"[-+]?(?:nan|inf|(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)")
_DURATION = re.compile(
    r"^(\s*(?:Max time spent|Total time|elapsed)[^=:]*[=:])")


def mask(line):
    """``line`` with each number as ``#``, no whitespace and every run of
    ``#`` (a histogram's bar too) as one."""
    return re.sub(r"#+", "#", re.sub(r"\s+", "", _NUMBER.sub("#", line)))


def _half_unit(tok):
    """Half a unit of the last digit printed in ``tok`` (0 for an
    integer)."""
    t = tok.lstrip("+-").lower()
    if t in ("nan", "inf"):
        return 0.0
    mant, _, exp = t.partition("e")
    if "." not in mant and not exp:
        return 0.0
    decimals = len(mant.partition(".")[2])
    return 0.5 * 10.0 ** (int(exp or 0) - decimals)


def _is_int(tok):
    return re.fullmatch(r"[-+]?\d+", tok) is not None


def _numbers_agree(ref, got):
    if _is_int(ref) and _is_int(got):
        return int(ref) == int(got)
    a, b = float(ref), float(got)
    if a != a or b != b:
        return a != a and b != b
    if a == b:
        return True
    tol = max(REL_TOL * abs(a) + ABS_TOL, _half_unit(ref), _half_unit(got))
    return abs(a - b) <= tol


def compare(ref, got, name=None):
    """The differences between the outputs ``ref`` and ``got`` of example
    ``name`` (a list of messages, empty when they match), under the
    example's entry in ``EXCEPTIONS``."""
    masked_only = None
    if name in EXCEPTIONS:
        pattern = EXCEPTIONS[name][1]
        masked_only = re.compile(pattern or "")
    rl, gl = ref.splitlines(), got.splitlines()
    if len(rl) != len(gl):
        return [f"{len(gl)} lines, the reference has {len(rl)}"]
    bad = []
    for k, (r, g) in enumerate(zip(rl, gl), 1):
        label = _DURATION.match(r) or DEVICE_TEXT.match(r)
        if label:
            if not g.startswith(label.group(1)):
                bad.append(f"line {k}: {g!r} against {r!r}")
            continue
        if mask(r) != mask(g):
            bad.append(f"line {k}: {g!r} against {r!r}")
            continue
        if masked_only is not None and masked_only.search(r):
            continue
        rn, gn = _NUMBER.findall(r), _NUMBER.findall(g)
        off = [(x, y) for x, y in zip(rn, gn) if not _numbers_agree(x, y)]
        if off:
            bad.append(f"line {k}: {off} in {g!r} against {r!r}")
    return bad
