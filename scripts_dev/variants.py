"""What the variant scripts share (``scripts_dev/*_variants.py``): build
variants of one CUDA source, bind their C entries, time callables in
rounds, name the card.

Each script takes arguments ``NAME=[@SOURCE] [NVCC FLAGS]``: NAME is
built with nvcc (the flags of ``kernels/_build.py`` plus the given ones;
``@path`` builds another source) into ``build/dev/``, all variants at
once, and its ptxas lines are printed.  Run from the repository root on
a machine with one H100.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT, ROOT / "scripts_dev"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

PTXAS_WORDS = ("Function properties", "registers", "spill", "error",
               "C75")


def parse(argv):
    """{name: nvcc arguments} from ``NAME=[@SOURCE] [FLAGS]`` words."""
    if not argv or any("=" not in a for a in argv):
        raise SystemExit("usage: NAME=[@SOURCE] [NVCC FLAGS] ...")
    return dict(a.split("=", 1) for a in argv)


def build(source: str, variants):
    """{name: ctypes.CDLL} for each variant of ``csrc/<source>.cu`` that
    builds, each C entry of ``_build._SIGNATURES[source]`` that it has
    bound.  A variant that does not build is reported and left out."""
    nvcc = _build.nvcc_path()
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        flags = flags.split()
        src = str(_build.CSRC / f"{source}.cu")
        if flags and flags[0].startswith("@"):
            src = flags.pop(0)[1:]
        so = out_dir / f"{source}_{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in PTXAS_WORDS):
                print(f"  ptxas {name}: {line.strip()[:200]}")
        if proc.returncode:
            print(f"{name}: build failed:\n{log[-3000:]}")
            continue
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in _build._SIGNATURES[source].items():
            if hasattr(lib, entry):   # an older source may lack one
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def rounds(fns, n_rounds: int = 2, timer=None):
    """{name: [one timing a round]}: every callable of ``fns`` timed
    once a round, the order reversed every other round; ``timer(fn)``
    defaults to ``chip_smoke.time_ms``."""
    timer = timer or cs.time_ms
    times = {name: [] for name in fns}
    for rnd in range(n_rounds):
        for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            times[name].append(timer(fns[name]))
    return times


def card() -> str:
    """The card's nvidia-smi name and power limit."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
