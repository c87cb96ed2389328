"""Dev script: build variants of csrc/sddmm.cu, check them, time them in turns.

    python scripts_dev/sddmm_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/sddmm_variants.py cur= new=@build/new.cu

Variants are built as ``scripts_dev/variants.py`` says, beside the
first design of the fused entry (``scripts_dev/sddmm_v1.cu``).  On the
slice of ``chip_smoke.py`` (``slice_data``: 131,072 compounds x 8,192
proteins, K = 128, N(0, 1) factors) each variant must give the first
design's bits at the three shapes the sweeps give the gathered sddmm:
the observed entries (``sddmm_gathered_f32``) and every slot of
probit's padded rows and columns (``sddmm_padded_f32``; the first
design over the slot rows).  Then each shape is timed
(``chip_smoke.time_ms``) in two rounds, the order reversed in the
second, the first design beside the variants.  Prints the card's
nvidia-smi name and power limit last.
"""
import functools
import sys

import variants as vs  # first: puts the repo's sources on sys.path

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import sddmm_v1  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

K = 128


def gathered(lib, U, V, i, j):
    out = torch.empty(i.shape[0], device="cuda")
    _build.check(lib.sddmm_gathered_f32(
        U.data_ptr(), V.data_ptr(), i.data_ptr(), j.data_ptr(),
        out.data_ptr(), i.shape[0], U.shape[1], U.shape[0], V.shape[0],
        int(U.shape[1] % 4 == 0), torch.cuda.current_stream().cuda_stream),
        "sddmm_gathered_f32")
    return out


def padded(lib, u, fixed, idx):
    out = torch.empty(idx.shape, device="cuda")
    _build.check(lib.sddmm_padded_f32(
        u.data_ptr(), fixed.data_ptr(), idx.data_ptr(), out.data_ptr(),
        idx.shape[0], idx.shape[1], u.shape[1], fixed.shape[0],
        int(u.shape[1] % 4 == 0), torch.cuda.current_stream().cuda_stream),
        "sddmm_padded_f32")
    return out


def main(argv) -> int:
    libs = vs.build("sddmm", vs.parse(argv))
    sddmm_v1.register()
    _build.build_all([sddmm_v1.NAME])
    train, _ = cs.slice_data(cs.COMPOUNDS, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    U = torch.randn(train.n_rows, K, device="cuda", generator=gen)
    V = torch.randn(train.n_cols, K, device="cuda", generator=gen)
    rows, cols = train.rows.idx, train.cols.idx
    row_slots = ref.slot_rows(*rows.shape, "cuda")
    col_slots = ref.slot_rows(*cols.shape, "cuda")
    shapes = {
        "observed": (lambda lib: gathered(lib, U, V, train.coo_i,
                                          train.coo_j),
                     lambda: sddmm_v1.gathered(U, V, train.coo_i,
                                               train.coo_j)),
        "rows side": (lambda lib: padded(lib, U, V, rows),
                      lambda: sddmm_v1.gathered(U, V, row_slots,
                                                rows.reshape(-1))),
        "cols side": (lambda lib: padded(lib, V, U, cols),
                      lambda: sddmm_v1.gathered(V, U, col_slots,
                                                cols.reshape(-1))),
    }
    for shape, (run, first) in shapes.items():
        want = first().view(torch.int32)
        for name, lib in libs.items():
            got = run(lib).reshape(-1).view(torch.int32)
            if not torch.equal(got, want):
                raise SystemExit(f"{name}: not the first design's bits at "
                                 f"the {shape}")
        print(f"{shape}: every variant gives the first design's bits")
        fns = {name: functools.partial(run, lib)
               for name, lib in libs.items()}
        fns["sddmm_v1"] = first
        for name, ts in vs.rounds(fns).items():
            print(f"  {name} {shape}: " + ", ".join(f"{t:.3f}" for t in ts)
                  + " ms")
    print(vs.card())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
