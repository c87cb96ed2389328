"""Dev script: build variants of csrc/topk_score.cu and time them in turns.

    python scripts_dev/topk_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    sed 's/STAGES = 3;/STAGES = 6;/' src/repro_torch/kernels/csrc/topk_score.cu > build/six.cu
    python scripts_dev/topk_variants.py three= six=@build/six.cu

Each NAME is built with nvcc (the flags of ``kernels/_build.py`` plus
the given ones; ``@path`` builds another source) into ``build/dev/``
and held against ``ref.topk_score_ref`` at each shape below, with the
plan ``kernels/topk_score.py`` picks.  Then its scoring pass and its
selection pass are timed apart, queued back to back
(``chip_smoke.queued_ms``, the device's time a launch), in two rounds,
the order of the variants reversed in the second.  Prints the card's
nvidia-smi name and power limit last.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import topk_score as ktopk  # noqa: E402

# (B, S, N, K, k): the serving path's two directions, the 512-sample
# store, and the store at k = 2,048 (the radix route)
SHAPES = [(8, 32, 8192, 128, 100), (8, 32, 131072, 128, 100),
          (8, 512, 8192, 128, 100), (8, 512, 8192, 128, 2048)]


def build(variants):
    nvcc = _build.nvcc_path()
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        flags = flags.split()
        src = str(_build.CSRC / "topk_score.cu")
        if flags and flags[0].startswith("@"):
            src = flags.pop(0)[1:]
        so = out_dir / f"topk_{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(name, "build failed:", log[-2000:])
            continue
        fn = getattr(ctypes.CDLL(str(so)), "topk_score_f32")
        fn.argtypes = _build._SIGNATURES["topk_score"]["topk_score_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, us, v, excl, k, passes, bufs):
    B, S, K = us.shape
    N = v.shape[1]
    p = ktopk.plan(B, N, k, cs._n_sm())
    err = fn(us.data_ptr(), v.data_ptr(), excl.data_ptr(),
             *(b.data_ptr() for b in bufs), bufs[3].numel(), B, S, N, K, k,
             p.tn, p.chunk, p.group, int(K % 4 == 0), passes,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "topk_score_f32")


def main(argv):
    fns = build(dict(a.split("=", 1) for a in argv))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, N, K, k in SHAPES:
        us = torch.randn(B, S, K, device="cuda", generator=gen)
        v = torch.randn(S, N, K, device="cuda", generator=gen)
        excl = (torch.rand(B, N, device="cuda", generator=gen)
                < 0.01).float()
        want = ops.finalize_topk(*ref.topk_score_ref(us, v, excl, k), excl)
        p = ktopk.plan(B, N, k, cs._n_sm())
        bufs = ktopk.buffers(B, N, k, p, "cuda")
        times = {}
        for rnd in range(2):
            for name in (list(fns) if rnd == 0 else list(fns)[::-1]):
                fn = fns[name]
                run(fn, us, v, excl, k, 3, bufs)
                got = ops.finalize_topk(*(b.clone() for b in bufs[:3]), excl)
                ref.check_topk_score(got, want, us, v, name)
                times.setdefault(name, []).append(tuple(
                    cs.queued_ms(lambda: run(fn, us, v, excl, k, passes,
                                             bufs)) for passes in (1, 2)))
        gb = S * N * K * 4 / 1e9
        print(f"B={B} S={S} N={N} K={K} k={k} {tuple(p)}, "
              f"{gb:.3f} GB of items, ms queued (scoring, selection):")
        for name, t in times.items():
            sc = sum(x[0] for x in t) / len(t)
            print(f"  {name}: " + "; ".join(f"{a:.4f}, {b:.4f}" for a, b in t)
                  + f"; scoring mean {sc:.4f} ({gb / sc * 1e3:.0f} GB/s)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
