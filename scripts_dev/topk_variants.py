"""Dev script: build variants of csrc/topk_score.cu and time them in turns.

    python scripts_dev/topk_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    sed 's/STAGES = 3;/STAGES = 6;/' src/repro_torch/kernels/csrc/topk_score.cu > build/six.cu
    python scripts_dev/topk_variants.py three= six=@build/six.cu

Variants are built as ``scripts_dev/variants.py`` says.  Each is held
against ``ref.topk_score_ref`` at each shape below, with the
plan ``kernels/topk_score.py`` picks.  Then its scoring pass and its
selection pass are timed apart, queued back to back
(``chip_smoke.queued_ms``, the device's time a launch), in two rounds,
the order of the variants reversed in the second.  Prints the card's
nvidia-smi name and power limit last.
"""
import functools
import sys

import variants as vs  # first: puts the repo's sources on sys.path

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import topk_score as ktopk  # noqa: E402

# (B, S, N, K, k): the serving path's two directions, the 512-sample
# store, and the store at k = 2,048 (the radix route)
SHAPES = [(8, 32, 8192, 128, 100), (8, 32, 131072, 128, 100),
          (8, 512, 8192, 128, 100), (8, 512, 8192, 128, 2048)]


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
    fns = {name: lib.topk_score_f32
           for name, lib in vs.build("topk_score", vs.parse(argv)).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, N, K, k in SHAPES:
        us = torch.randn(B, S, K, device="cuda", generator=gen)
        v = torch.randn(S, N, K, device="cuda", generator=gen)
        excl = (torch.rand(B, N, device="cuda", generator=gen)
                < 0.01).float()
        want = ops.finalize_topk(*ref.topk_score_ref(us, v, excl, k), excl)
        p = ktopk.plan(B, N, k, cs._n_sm())
        bufs = ktopk.buffers(B, N, k, p, "cuda")

        def timed(name, fn):
            run(fn, us, v, excl, k, 3, bufs)
            got = ops.finalize_topk(*(b.clone() for b in bufs[:3]), excl)
            ref.check_topk_score(got, want, us, v, name)
            return tuple(cs.queued_ms(lambda: run(fn, us, v, excl, k,
                                                  passes, bufs))
                         for passes in (1, 2))

        times = vs.rounds({name: functools.partial(timed, name, fn)
                           for name, fn in fns.items()},
                          timer=lambda f: f())
        gb = S * N * K * 4 / 1e9
        print(f"B={B} S={S} N={N} K={K} k={k} {tuple(p)}, "
              f"{gb:.3f} GB of items, ms queued (scoring, selection):")
        for name, t in times.items():
            sc = sum(x[0] for x in t) / len(t)
            print(f"  {name}: " + "; ".join(f"{a:.4f}, {b:.4f}" for a, b in t)
                  + f"; scoring mean {sc:.4f} ({gb / sc * 1e3:.0f} GB/s)")
    print(vs.card())


if __name__ == "__main__":
    main(sys.argv[1:])
