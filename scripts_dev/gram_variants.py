"""Dev script: build variants of csrc/gram.cu, check them, time them in turns.

    python scripts_dev/gram_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/gram_variants.py cur= new=-DMACRO

Variants are built as ``scripts_dev/variants.py`` says, beside the
first design (``scripts_dev/gram_v1.cu``).  Each variant's gathered
entry is held against ``ref.gathered_gram_ref`` at
``chip_smoke.GRAM_TOL`` on small shapes
(K = 1, 7, 33, 128 and 256, ragged T, empty rows, acc, a lam that is
not symmetric) and on 4,096 rows of each of the slice's two half-sweep
shapes (``chip_smoke.slice_data``); at the two whole shapes it must
give the bits of the first design's pipeline (gather, ``gram_v1``,
``mul_``, ``add_``).  Then each variant's launch is timed at both
shapes (``chip_smoke.time_ms``) in two rounds, the order reversed in
the second, beside the pipeline.  Prints the card's nvidia-smi name and
power limit last.
"""
import functools
import sys

import variants as vs  # first: puts the repo's sources on sys.path

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import gram_v1  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

K = 128


def run(fn, fixed, idx, val, mask, alpha, acc=None, lam=None):
    R, T = idx.shape
    Kf = fixed.shape[1]
    if acc is None:
        g = torch.empty((R, Kf, Kf), device="cuda")
        r = torch.empty((R, Kf), device="cuda")
    else:
        g, r = acc
    err = fn(fixed.data_ptr(), idx.data_ptr(), val.data_ptr(),
             mask.data_ptr(), alpha.data_ptr(),
             g.data_ptr() if acc is not None else None,
             r.data_ptr() if acc is not None else None,
             lam.data_ptr() if lam is not None else None, g.data_ptr(),
             r.data_ptr(), R, T, Kf, fixed.shape[0],
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gram_gathered_f32")
    return g, r


def inputs(R, T, Kf, n_fixed, gen, empty_rows=0):
    fixed = torch.randn(n_fixed, Kf, device="cuda", generator=gen)
    idx = torch.randint(0, n_fixed, (R, T), device="cuda", generator=gen,
                        dtype=torch.int32)
    val = torch.randn(R, T, device="cuda", generator=gen)
    mask = (torch.rand(R, T, device="cuda", generator=gen) > 0.3).float()
    mask[:empty_rows] = 0
    return fixed, idx, val, mask


def check(name, fn, fixed, idx, val, mask, alpha, lam, acc_too, label):
    Kf = fixed.shape[1]
    lam_abs = lam.abs() if lam is not None else None
    acc = None
    if acc_too:
        acc = (torch.randn(idx.shape[0], Kf, Kf, device="cuda"),
               torch.randn(idx.shape[0], Kf, device="cuda"))
    want = ref.gathered_gram_ref(
        fixed, idx, val, mask, alpha, lam=lam,
        acc=None if acc is None else (acc[0].clone(), acc[1].clone()))
    scale = ref.gathered_gram_ref(
        fixed.abs(), idx, val.abs(), mask, alpha, lam=lam_abs,
        acc=None if acc is None else (acc[0].abs(), acc[1].abs()))
    got = run(fn, fixed, idx, val, mask, alpha, acc=acc, lam=lam)
    torch.cuda.synchronize()
    e = max(cs.max_err(got[0], want[0], scale[0], cs.GRAM_TOL,
                       f"{name} gram {label}"),
            cs.max_err(got[1], want[1], scale[1], cs.GRAM_TOL,
                       f"{name} rhs {label}"))
    print(f"  {name} {label}: max abs err {e:.3e}")


def main(argv):
    fns = {name: lib.gram_gathered_f32
           for name, lib in vs.build("gram", vs.parse(argv)).items()}
    gram_v1.register()
    _build.build_all([gram_v1.NAME])
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = torch.tensor(1.7, device="cuda")
    for (R, T, Kf, nf, empty) in ((3, 5, 1, 4, 1), (5, 37, 7, 20, 1),
                                  (13, 257, 33, 50, 2),
                                  (300, 70, 128, 1000, 3),
                                  (4, 40, 256, 30, 1)):
        fixed, idx, val, mask = inputs(R, T, Kf, nf, gen, empty)
        lam = torch.randn(Kf, Kf, device="cuda", generator=gen)
        for name, fn in fns.items():
            for acc_too in (False, True):
                check(name, fn, fixed, idx, val, mask, alpha, lam, acc_too,
                      f"R={R} T={T} K={Kf} acc={acc_too}")
    train, _ = cs.slice_data(cs.COMPOUNDS, 0, "cuda")
    U = torch.randn(train.n_rows, K, device="cuda", generator=gen)
    V = torch.randn(train.n_cols, K, device="cuda", generator=gen)
    lam = torch.randn(K, K, device="cuda", generator=gen)
    for side, padded, fixed in (("rows", train.rows, V),
                                ("cols", train.cols, U)):
        idx, val, mask = padded.idx, padded.val, padded.mask
        R, T = idx.shape
        for name, fn in fns.items():
            check(name, fn, fixed, idx[:4096], val[:4096], mask[:4096],
                  alpha, lam, False, f"4096 {side} T={T}")
        want = gram_v1.pipeline(fixed, idx, val, mask, alpha, lam)
        for name, fn in fns.items():
            got = run(fn, fixed, idx, val, mask, alpha, lam=lam)
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want))
            print(f"  {name} {side} R={R} T={T}: bitwise the first "
                  f"design's pipeline: {same}")
            if not same:
                raise AssertionError(f"{name} {side}: bits differ")
            del got
        del want
        torch.cuda.empty_cache()
        nnz = float(mask.sum())
        b_ms, b_by = cs.bound(4 * (fixed.numel() + 3 * R * T + R * K * K
                                   + R * K),
                              nnz * K * (K + 1) + 2 * nnz * K)
        timed = {name: functools.partial(run, fn, fixed, idx, val, mask,
                                         alpha, lam=lam)
                 for name, fn in fns.items()}
        timed["pipeline (gather, gram_v1, mul_, add_)"] = (
            lambda: gram_v1.pipeline(fixed, idx, val, mask, alpha, lam))
        times = vs.rounds(timed, timer=lambda f: cs.time_ms(f, n=10))
        torch.cuda.empty_cache()
        print(f"{side} R={R} T={T} K={K} nnz={nnz:.0f}: bound {b_ms:.3f} ms "
              f"by {b_by}; ms a call, two rounds:")
        for name, t in times.items():
            m = sum(t) / len(t)
            print(f"  {name}: " + ", ".join(f"{x:.3f}" for x in t)
                  + f"; mean {m:.3f}, {b_ms / m:.3f} of the bound")
    print(vs.card())


if __name__ == "__main__":
    main(sys.argv[1:])
