#!/usr/bin/env python3
"""Run the PyTorch port of SMURFF on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

From the root of a checkout, on a machine with one NVIDIA H100:

1. card: prints the ``nvidia-smi`` name and power limit, and builds the
   CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. kernels: holds each kernel against its plain PyTorch version at the
   reference's probe shapes and at the shapes of the main path, and
   times kernel, plain version and one library call (CUDA events,
   median of 20 launches).  gram's gathered entry (the sweep's: gather,
   Gram, alpha and Lambda_p in one launch) is also held bitwise against
   the pipeline it replaced (``index_select``, the first design
   ``scripts_dev/gram_v1.cu``, ``mul_``, ``add_``) at both half-sweep
   shapes and timed beside it, part by part;
3. golden chain: replays the ``gaussian`` chain of
   ``results/golden_chains.json`` on the card;
4. slice: runs ``ModelBuilder(num_latent=128)`` -> ``session(...).run()``
   on a ChEMBL-shaped matrix (131,072 compounds x 8,192 proteins, 64
   proteins per compound, a planted rank-16 signal plus 0.3 noise, and
   a 10% held-out test set) and reads the kernels' launch counts;
5. profile: one more sweep under ``torch.profiler``, the device's
   idle share and device time by kernel;
6. witness: the same data at K = 16, the planted rank, for 30 sweeps;
   the test RMSE must fall below twice the planted noise;
7. serving: trains a 32-sample store of the slice (``save_freq=1``),
   reloads it with ``PredictSession`` (predictions must reproduce the
   in-session posterior mean), serves 64 requests in each direction of
   the block through ``RecommendServer`` (compound -> proteins and
   protein -> compounds, each excluding the query's training items),
   holds every answer bitwise against a sequential ``recommend``, and
   holds the ``topk_score`` kernel against its plain version at the
   reference's probes, at both path shapes and at k = 2,048 and k = N
   of the 8,192 proteins; times it (a call, its scoring pass and its
   selection pass apart) beside its first design
   (``scripts_dev/topk_score_v1.cu``), the plain version and one
   library expression; then writes a store of 512 seeded samples at
   K = 128 (2,048 compounds x 8,192 proteins) with the port's
   checkpoint code and serves ``PredictSession.recommend_rows`` from it
   at k = 100 and k = 2,048, held bitwise against B = 1 calls and
   against the plain version;
8. lm: holds the ``flash`` kernels against their plain version at the
   reference's probes, ragged cases, GQA groups of 3 and 1 at hd 64
   and the prefill shape, each through the design ``flash.design``
   routes it to (``flash_sm90`` for bf16 at hd 64 and 128), and times
   ``flash_sm90``, the PR-14 kernel of ``flash.cu``, PyTorch's SDPA and
   the plain version in turns at the forward's shape; builds Qwen3-4B
   at full width and depth with random weights on the card; runs
   ``forward`` on 4 prompts of 4,096 tokens (36 flash launches each,
   all on ``flash_sm90``, the kernel held against its plain version at
   the first and last layer's captured inputs), ``generate`` on 8
   prompts of 128 tokens
   (decode held against forward) and ``BatchedServer`` (8 slots: the
   same 8 prompts, bitwise ``generate``'s tokens; then 16 requests).

Every failed check raises, so the exit code is not 0.  The last two
lines are the ``kernels`` JSON and the device JSON.  Without a CUDA
device, or outside a checkout, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "results" / "golden_chains.json"

# H100 SXM data sheet: fp32 outside the tensor cores, bf16 dense in the
# tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the slice: bmf_chembl's widths with the compounds cut to one card
COMPOUNDS = 131072
SWEEPS = (4, 2)   # burn-in, posterior samples
NOISE = 0.3       # sd of the Gaussian noise on the planted signal
WITNESS_SWEEPS = (20, 10)

SERVE_SWEEPS = (4, 32)    # burn-in, saved posterior samples
SERVE_SLOTS, SERVE_K, SERVE_REQUESTS = 8, 100, 64
SERVE_CACHE_BYTES = 8 << 30
# the 512-sample store: compounds, proteins, samples; served at k = 100
# and at k = 2,048
STORE512 = (2048, 8192, 512)
STORE512_K = 2048
PREVIOUS_TOPK = "scripts_dev/topk_score_v1.cu"
PREVIOUS_GRAM = "scripts_dev/gram_v1.cu"
# the store's reload runs the in-session accumulator's float program
# over exact copies of the samples: the same bits are expected, and
# 1e-6 relative (the reference's reload tolerance) is what is held
RELOAD_TOL = dict(rtol=1e-6, atol=1e-6)

GRAM_TOL = dict(rtol=1e-5, atol=1e-4)
SDDMM_TOL = dict(rtol=1e-5, atol=1e-5)
TOL_REASON = ("fp32 on both sides, summed in another order: the kernel "
              "walks t (gram) or k (sddmm) in its own order, the plain "
              "version through cuBLAS.  The rounding error of a sum "
              "grows with the sum of its terms' magnitudes, so rtol "
              "applies to that sum, the same function of |inputs|: "
              "|kernel - plain| <= atol + rtol * f(|inputs|)")


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32_FLOPS):
    """(ms, 'bytes'|'operations'): the least time on the card."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def queued_ms(fn, n: int = 20) -> float:
    """Mean of n launches queued back to back between two CUDA events:
    the device's time a launch once the host runs ahead of it."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def time_ms(fn, n: int = 20) -> float:
    """Median of n launches, each between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def max_err(got, want, scale, tol, what: str) -> float:
    """Max |got - want|; raises unless every element is within
    ``atol + rtol * scale``, ``scale`` the sum of the terms' magnitudes."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    diff = (got - want).abs()
    bad = diff > tol["atol"] + tol["rtol"] * scale
    if bad.any():
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} elements, max abs diff "
            f"{diff.max().item():.3e}, tolerance {tol} of the magnitude")
    return diff.max().item()


def slice_data(n_compounds: int, seed: int, device):
    """ChEMBL-shaped data from numpy: every compound has 64 training and
    7 held-out proteins, all distinct, of 8,192; values are a planted
    rank-16 product plus 0.3 Gaussian noise.  Built through the port's
    ``from_coo``."""
    import numpy as np
    from repro_torch.core import from_coo
    n_proteins, per_row, n_test, rank = 8192, 64, 7, 16
    need = per_row + n_test
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_compounds, rank)).astype(np.float32)
    V = rng.normal(size=(n_proteins, rank)).astype(np.float32)
    # 96 draws hold 71 distinct proteins but with odds below 1e-30;
    # a random key per distinct draw picks 71 of them uniformly
    cand = np.sort(rng.integers(0, n_proteins, (n_compounds, 96)), axis=1)
    keys = rng.random(cand.shape)
    keys[:, 1:][cand[:, 1:] == cand[:, :-1]] = 2.0
    order = np.argsort(keys, axis=1)[:, :need]
    if (np.take_along_axis(keys, order, axis=1) > 1.0).any():
        raise AssertionError("a compound drew fewer than 71 proteins")
    picked = np.take_along_axis(cand, order, axis=1)
    rows = np.repeat(np.arange(n_compounds), need).reshape(n_compounds,
                                                            need)
    vals = np.einsum("rtk,rtk->rt", U[rows], V[picked]) + NOISE * rng.normal(
        size=picked.shape)
    vals = vals.astype(np.float32)
    tr, te = slice(0, per_row), slice(per_row, need)
    train = from_coo(rows[:, tr].ravel(), picked[:, tr].ravel(),
                     vals[:, tr].ravel(), (n_compounds, n_proteins),
                     device=device)
    test = (rows[:, te].ravel(), picked[:, te].ravel(), vals[:, te].ravel())
    return train, test


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(smi)
    print(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build
    import gram_v1
    import topk_score_v1
    gram_v1.register()         # the previous designs, timed beside
    topk_score_v1.register()
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
          + ", ".join(f"{k} {v:.2f} s"
                      for k, v in sorted(_build.build_seconds.items())))
    for name in ("gram", "sddmm", "topk_score", "flash", "flash_sm90"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # the main path launches gram_rows_kernel<float>: its ptxas lines,
    # named, and no spill
    spills = gram_ptxas(_build.build_log("gram"))
    for kernel, lines in spills.items():
        print(f"  ptxas gram {kernel}: " + "; ".join(lines))
    main = [k for k in spills if k == "gram_rows_kernel<float>"]
    if not main or any(" 0 bytes spill stores" not in line
                       for line in spills[main[0]] if "spill" in line):
        raise AssertionError(f"gram's main-path kernel spills or is "
                             f"missing: {spills}")
    return smi


def gram_ptxas(log: str):
    """{kernel: its ptxas lines} of gram.cu's build log, kernels named
    from their mangled entry names."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"(gram_rows_kernel|gram_tiled_kernel)I"
                          r"(13__nv_bfloat16|f)(Lb[01])?", mangled)
            name = mangled if k is None else (
                f"{k.group(1)}<{'bf16' if 'bfloat' in k.group(2) else 'float'}"
                + (f", {k.group(3)[-1] == '1'}" if k.group(3) else "") + ">")
            out[name] = []
        elif name and ("spill" in line or "registers" in line):
            out[name].append(line.strip())
    return out


def phase_kernels(train, gen):
    """Kernel vs plain version, at probes and at the main path's shapes;
    returns the kernels' entries (without launches)."""
    import torch
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sddmm as ksddmm
    dev = train.device
    K = 128
    print(f"tolerance: gram/rhs rtol={GRAM_TOL['rtol']} "
          f"atol={GRAM_TOL['atol']}, sddmm rtol={SDDMM_TOL['rtol']} "
          f"atol={SDDMM_TOL['atol']} ({TOL_REASON})")

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    errs = {"gram": 0.0, "sddmm": 0.0}

    def check_gram(vg, val, mask, label, fp64=False):
        g, r = kgram.gram_cuda(vg, val, mask)
        torch.cuda.synchronize()
        gr, rr = ref.gram_ref(vg, val, mask)
        gs, rs = ref.gram_ref(vg.abs(), val.abs(), mask.abs())
        e = max(max_err(g, gr, gs, GRAM_TOL, f"gram {label}"),
                max_err(r, rr, rs, GRAM_TOL, f"rhs {label}"))
        errs["gram"] = max(errs["gram"], e)
        extra = ""
        if fp64:
            v64 = vg.double()
            g64 = torch.einsum("rtk,rtl->rkl", v64 * mask.double()[..., None],
                               v64)
            extra = (f"; vs fp64: kernel {(g - g64).abs().max().item():.3e}"
                     f", plain {(gr - g64).abs().max().item():.3e}")
        print(f"  gram {label}: max abs err {e:.3e}{extra}")

    def check_sddmm(u, v, label):
        p = ksddmm.sddmm_cuda(u, v)
        torch.cuda.synchronize()
        e = max_err(p, ref.sddmm_ref(u, v), ref.sddmm_ref(u.abs(), v.abs()),
                    SDDMM_TOL, f"sddmm {label}")
        errs["sddmm"] = max(errs["sddmm"], e)
        print(f"  sddmm {label}: max abs err {e:.3e}")

    for label, ((R, T, k), dtype) in ops.KERNELS["gram"].items():
        mask = (torch.rand(R, T, device=dev, generator=gen) > 0.2).float()
        check_gram(rand(R, T, k).to(dtype), rand(R, T).to(dtype),
                   mask.to(dtype), f"{label} {str(dtype)[6:]}")
    for label, (E, k) in ops.KERNELS["sddmm"].items():
        check_sddmm(rand(E, k), rand(E, k), label)

    # the main path's operands: a N(0, 1) factor gathered over the data
    U = rand(train.n_rows, K)
    V = rand(train.n_cols, K)

    def slab(padded, fixed, rows=None):
        idx, val, mask = padded.idx, padded.val, padded.mask
        if rows is not None:
            idx, val, mask = idx[:rows], val[:rows], mask[:rows]
        R, T = idx.shape
        vg = fixed.index_select(0, idx.reshape(-1)).reshape(R, T, K)
        return vg, val.contiguous(), mask.contiguous()

    for name, padded, fixed in (("rows", train.rows, V),
                                ("cols", train.cols, U)):
        check_gram(*slab(padded, fixed, 4096),
                   f"4096 {name} of the slice T={padded.max_nnz} K={K}",
                   fp64=True)
    n1m = 1 << 20
    check_sddmm(U.index_select(0, train.coo_i[:n1m]),
                V.index_select(0, train.coo_j[:n1m]),
                f"{n1m} entries of the slice K={K}")

    gram = gram_main_path(train, U, V, gen, errs)

    ug = U.index_select(0, train.coo_i)
    vg = V.index_select(0, train.coo_j)
    E = ug.shape[0]
    check_sddmm(ug, vg, f"main path E={E} K={K}")
    s_ms = time_ms(lambda: ksddmm.sddmm_cuda(ug, vg))
    s_plain = time_ms(lambda: ref.sddmm_ref(ug, vg))
    s_lib = time_ms(lambda: torch.linalg.vecdot(ug, vg))
    s_bytes, s_ops = 4 * (2 * E * K + E), 2 * E * K
    sb_ms, sb_by = bound(s_bytes, s_ops)
    print(f"  sddmm E={E} K={K}: {s_ms:.3f} ms, plain {s_plain:.3f} ms, "
          f"torch.linalg.vecdot {s_lib:.3f} ms, bound {sb_ms:.3f} ms by "
          f"{sb_by}, {s_bytes / s_ms / 1e6:.0f} GB/s")
    del ug, vg, U, V
    torch.cuda.empty_cache()
    gram["max_abs_err"] = errs["gram"]
    return {
        "gram": gram,
        "sddmm": {
            "name": "sddmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sddmm.cu",
            "replaces": "src/repro/kernels/sddmm.py:53",
            "max_abs_err": errs["sddmm"], "ms": s_ms, "plain_ms": s_plain,
            "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": s_lib},
    }


def gram_library(fixed, idx, val, mask, alpha, lam):
    """One PyTorch expression of the gathered entry, the yardstick:
    gather, mask, ``torch.bmm`` for the Gram and the rhs, ``mul_`` by
    alpha, ``add_`` of Lambda_p."""
    import torch
    R, T = idx.shape
    vg = fixed.index_select(0, idx.reshape(-1)).reshape(R, T, -1)
    vgm = vg * mask[..., None]
    g = torch.bmm(vgm.mT, vg).mul_(alpha).add_(lam)
    r = torch.bmm(vg.mT, (val * mask)[..., None])[..., 0].mul_(alpha)
    return g, r


def gram_main_path(train, U, V, gen, errs):
    """The sweep's gathered gram at both half-sweep shapes: held against
    its plain version (``ref.gathered_gram_ref``) at GRAM_TOL, with the
    slice's noise precision for alpha and a Lambda_p that is not
    symmetric, once with acc; bitwise against the pipeline it replaced;
    timed beside that pipeline part by part, the pre-gathered entry, the
    plain version and one library expression.  Returns the kernels-line
    entry (without launches and max_abs_err)."""
    import torch
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ref
    import gram_v1 as previous
    K = U.shape[1]
    dev = U.device
    # the adaptive noise's precision near the planted noise, and a
    # Wishart-like precision with an asymmetric perturbation
    alpha = torch.tensor(1.0 / NOISE ** 2, device=dev)
    W = torch.randn(K, K, device=dev, generator=gen)
    lam = W @ W.mT / K + 1e-3 * torch.randn(K, K, device=dev, generator=gen)
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
         "previous_ms": 0.0}
    by = {"bytes": 0.0, "operations": 0.0}
    for name, padded, fixed in (("rows", train.rows, V),
                                ("cols", train.cols, U)):
        idx, val, mask = padded.idx, padded.val, padded.mask
        R, T = idx.shape
        label = f"{name} R={R} T={T} K={K}"
        for with_acc in (False, True):
            acc = None
            if with_acc:
                acc = (torch.randn(R, K, K, device=dev, generator=gen),
                       torch.randn(R, K, device=dev, generator=gen))
            got = kgram.gathered_gram_cuda(
                fixed, idx, val, mask, alpha, lam=lam,
                acc=None if acc is None else tuple(a.clone() for a in acc))
            torch.cuda.synchronize()
            want = ref.gathered_gram_ref(
                fixed, idx, val, mask, alpha, lam=lam,
                acc=None if acc is None else tuple(a.clone() for a in acc))
            scale = ref.gathered_gram_ref(
                fixed.abs(), idx, val.abs(), mask, alpha, lam=lam.abs(),
                acc=None if acc is None else tuple(a.abs() for a in acc))
            e = max(max_err(got[0], want[0], scale[0], GRAM_TOL,
                            f"gathered gram {label}"),
                    max_err(got[1], want[1], scale[1], GRAM_TOL,
                            f"gathered rhs {label}"))
            del want, scale
            prev = previous.pipeline(
                fixed, idx, val, mask, alpha, lam=lam,
                acc=None if acc is None else tuple(a.clone() for a in acc))
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, prev))
            if not same:
                raise AssertionError(
                    f"gathered gram {label}: not the bits of the previous "
                    f"pipeline (index_select, {PREVIOUS_GRAM}, mul_, add_)")
            errs["gram"] = max(errs["gram"], e)
            print(f"  gathered gram {label} alpha={alpha.item():.4f} lam not "
                  f"symmetric{', acc' if with_acc else ''}: gram and rhs max "
                  f"abs err {e:.3e} against the plain version; bitwise "
                  f"equal to the previous pipeline (index_select, "
                  f"{PREVIOUS_GRAM}, mul_, add_)")
            del got, prev, acc
            torch.cuda.empty_cache()
        # times: the launch, the previous pipeline part by part, the
        # pre-gathered entry, the plain version, the library expression
        nnz = float(mask.sum())
        n_bytes = 4 * (fixed.numel() + 3 * R * T + R * K * K + R * K)
        n_ops = nnz * K * (K + 1) + 2 * nnz * K
        b_ms, b_by = bound(n_bytes, n_ops)
        ms = time_ms(lambda: kgram.gathered_gram_cuda(fixed, idx, val, mask,
                                                      alpha, lam=lam))
        vg = previous.gather(fixed, idx)
        parts = {"gather": time_ms(lambda: previous.gather(fixed, idx))}
        g, r = previous.gram(vg, val, mask)
        parts["gram_v1"] = time_ms(lambda: previous.gram(vg, val, mask))
        parts["mul_ (gram, rhs)"] = time_ms(
            lambda: (g.mul_(alpha), r.mul_(alpha)))
        parts["add_ (Lambda_p)"] = time_ms(lambda: g.add_(lam))
        del g, r
        pre = time_ms(lambda: kgram.gram_cuda(vg, val, mask))
        del vg
        torch.cuda.empty_cache()
        prev_ms = time_ms(lambda: previous.pipeline(fixed, idx, val, mask,
                                                    alpha, lam=lam))
        plain = time_ms(lambda: ref.gathered_gram_ref(fixed, idx, val, mask,
                                                      alpha, lam=lam), n=5)
        lib = time_ms(lambda: gram_library(fixed, idx, val, mask, alpha,
                                           lam), n=5)
        torch.cuda.empty_cache()
        print(f"  gathered gram {label}: {ms:.3f} ms, bound {b_ms:.3f} ms by "
              f"{b_by} ({n_ops / 1e9:.1f} GFLOP, {n_bytes / 1e9:.2f} GB; "
              f"{b_ms / ms:.3f} of it, {n_ops / ms / 1e9:.1f} TFLOP/s, "
              f"{n_bytes / ms / 1e6:.0f} GB/s); previous pipeline "
              f"{prev_ms:.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f"); pre-gathered entry on the slab {pre:.3f} ms; plain "
              f"{plain:.3f} ms; library (gather, mask, torch.bmm, mul_, "
              f"add_) {lib:.3f} ms")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms), ("previous_ms", prev_ms)):
            t[key] += v
        by[b_by] += b_ms
    g_by = max(by, key=by.get)
    print(f"  gathered gram, both half-sweeps: {t['ms']:.3f} ms, bound "
          f"{t['bound_ms']:.3f} ms (" + ", ".join(
              f"{v:.3f} by {k}" for k, v in by.items())
          + f"), previous pipeline {t['previous_ms']:.3f} ms, library "
          f"{t['library_ms']:.3f} ms")
    return {"name": "gram", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gram.cu",
            "replaces": "src/repro/kernels/gram.py:83", "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": g_by, "library_ms": t["library_ms"],
            "previous_ms": t["previous_ms"],
            "previous_source": PREVIOUS_GRAM}


def phase_golden():
    """The golden ``gaussian`` chain (48 x 32, K=4, seed 11) on the card."""
    import numpy as np
    from repro_torch.core import (AdaptiveGaussian, BlockDef, EntityDef,
                                  MFData, ModelDef, NormalPrior,
                                  gibbs_step, init_state, random_sparse)
    golden = json.loads(GOLDEN.read_text())
    seed, sweeps = golden["seed"], golden["sweeps"]
    K = 4
    mat, _, _ = random_sparse(seed, (48, 32), 0.3, rank=3, device="cuda")
    model = ModelDef((EntityDef("r", 48, NormalPrior(K)),
                      EntityDef("c", 32, NormalPrior(K))),
                     (BlockDef(0, 1, AdaptiveGaussian(), sparse=True),), K,
                     device="cuda")
    data = MFData((mat,), (None, None))
    state = init_state(model, data, seed=seed)
    got = {"rmse_train": [], "alpha": []}
    for _ in range(sweeps):
        state, m = gibbs_step(model, data, state)
        got["rmse_train"].append(float(m["rmse_train_0"]))
        got["alpha"].append(float(m["alpha_0"]))
    want = golden["chains"]["gaussian"]
    for key in ("rmse_train", "alpha"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   atol=1e-5, err_msg=f"golden {key}")
    print(f"golden gaussian chain on cuda: rmse_train {got['rmse_train']}"
          f", alpha {got['alpha']} (fixture {want}); rtol 1e-3 atol 1e-5")


def phase_slice(train, test, burnin: int, nsamples: int, seed: int):
    """The main path through the entry points a user calls."""
    import math
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    from repro_torch.kernels import ops

    b = ModelBuilder(num_latent=128)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, test=test,
                noise=AdaptiveGaussian())
    sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed)
    stamps = []

    def stamp(info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    sess.callbacks = (stamp,)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sess.run()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sweeps = burnin + nsamples
    edges = [t0] + stamps
    sweep_ms = [(edges[i + 1] - edges[i]) * 1e3 for i in range(sweeps)]
    for s in range(sweeps):
        print(f"  sweep {s} ({'burnin' if s < burnin else 'sample'}): "
              f"{sweep_ms[s]:.1f} ms, rmse_train "
              f"{res.rmse_train_trace[s]:.6f}")
    print(f"slice: rmse_test {res.rmse_test:.6f}, runtime_s "
          f"{res.runtime_s:.3f}, peak device memory "
          f"{peak / 1e9:.2f} GB, launches {counts}")
    vals = res.rmse_train_trace + [res.rmse_test]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"slice: non-finite metrics {vals}")
    for f in res.state.factors:
        if not torch.isfinite(f).all():
            raise AssertionError("slice: non-finite factor")
    # the chain must learn: some later sweep fits the training entries
    # better than the first (in burn-in the trace need not be monotone)
    first, later = res.rmse_train_trace[0], res.rmse_train_trace[1:]
    if not min(later) < first:
        raise AssertionError(
            f"slice: rmse_train never fell below the first sweep's: "
            f"{res.rmse_train_trace}")
    # gram: one launch per half-sweep; sddmm: one per sweep for the
    # training residual plus one per posterior sample for the test set
    want = {"gram": 2 * sweeps, "sddmm": sweeps + nsamples,
            "topk_score": 0, "flash": 0}
    if counts != want:
        raise AssertionError(f"slice: launch counts {counts}, want {want}")
    return sess, res, counts, sweep_ms


def phase_witness(train, test, seed: int):
    """The slice's data at K = 16, the planted rank, run to convergence:
    on the card, the test-set predictions (``PredictAccumulator`` and the
    test-set sddmm) must come near the planted noise.  At K = 128 with
    64 observations per compound six sweeps cannot show that."""
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    b = ModelBuilder(num_latent=16)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, test=test,
                noise=AdaptiveGaussian())
    res = b.session(burnin=WITNESS_SWEEPS[0], nsamples=WITNESS_SWEEPS[1],
                    seed=seed).run()
    zero = float(torch.as_tensor(test[2]).square().mean().sqrt())
    print(f"witness K=16, {sum(WITNESS_SWEEPS)} sweeps: rmse_train "
          f"{res.rmse_train_trace[0]:.4f} -> {res.rmse_train_trace[-1]:.4f}"
          f", rmse_test {res.rmse_test:.4f} (planted noise {NOISE}, "
          f"predicting 0 gives {zero:.4f}), runtime_s {res.runtime_s:.3f}")
    if not res.rmse_test < 2 * NOISE:
        raise AssertionError(f"witness: rmse_test {res.rmse_test} is not "
                             f"below twice the planted noise {NOISE}")


def observed_items(padded, users):
    """Each user's training items, from the padded rows of the data."""
    idx = padded.idx[users].cpu().numpy()
    mask = padded.mask[users].cpu().numpy() > 0
    return [row[m] for row, m in zip(idx, mask)]


def plain_topk(us, v, k, excl):
    """The plain version on the same device, finalized as ops does."""
    from repro_torch.kernels import ops, ref
    return ops.finalize_topk(*ref.topk_score_ref(us, v, excl, k), excl)


def library_topk(us, v, k, excl):
    """One PyTorch expression of the same function, as a yardstick: a
    batched einsum, the moments over samples and ``torch.topk`` (whose
    ties are not ordered by id)."""
    import torch
    scores = torch.einsum("bsk,snk->bsn", us, v)
    mean = scores.mean(1)
    ex2 = (scores * scores).mean(1)
    top = torch.topk(torch.where(excl > 0, -torch.inf, mean), k, dim=1)
    return top.indices, mean.gather(1, top.indices), ex2.gather(
        1, top.indices)


def topk_bound(B, S, N, K, k):
    """(ms, by) of one call: us, the item stack and the mask read once,
    the (B, k) outputs written once; 2*B*S*N*K operations for the scores
    and 3*B*S*N for the moments."""
    n_bytes = 4 * (B * S * K + S * N * K + B * N) + 12 * B * k
    return bound(n_bytes, 2 * B * S * N * K + 3 * B * S * N)


def same_bits(a, b) -> bool:
    import numpy as np
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def step_breakdown(sess, path):
    """Where one server step of 8 requests goes: the step under
    torch.profiler (device busy and idle share), then its parts timed
    one by one, each ended by a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RecommendServer
    users = [int(u) for u in path["users"][:SERVE_SLOTS]]
    excl = path["excl"][:SERVE_SLOTS]
    srv = RecommendServer(sess, slots=SERVE_SLOTS, k=SERVE_K,
                          block=path["block"])
    for u, e in zip(users, excl):
        srv.submit(user=u, exclude=e)
    srv._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    if not 0 < busy <= wall:
        raise AssertionError(f"serving profile: busy {busy} of {wall} ms")
    _, ie = sess._block_entities(path["block"])
    v = sess.warm_cache().factors[ie]
    parts = {}
    t = time.perf_counter()
    rows = torch.cat([sess.user_rows([u], path["block"]) for u in users])
    torch.cuda.synchronize()
    parts["user rows (8 gathers)"] = time.perf_counter() - t
    t = time.perf_counter()
    mask = torch.from_numpy(sess._exclude_mask(
        excl, SERVE_SLOTS, v.shape[1])).to("cuda")
    torch.cuda.synchronize()
    parts["exclusion mask (host) + copy"] = time.perf_counter() - t
    t = time.perf_counter()
    out = ops.topk_score(rows, v, SERVE_K, exclude=mask)
    torch.cuda.synchronize()
    parts["ops.topk_score (kernel + finalize)"] = time.perf_counter() - t
    t = time.perf_counter()
    [x.cpu().numpy() for x in out]
    parts["results to host"] = time.perf_counter() - t
    print(f"  one step, {path['label']}: {wall:.3f} ms wall under the "
          f"profiler, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; parts unprofiled: "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in parts.items()))


def same_as_single_calls(us, v, k, excl, label):
    """Raise unless a batched ``ops.topk_score`` call is the same bits as
    one call per user."""
    import torch
    from repro_torch.kernels import ops
    got = ops.topk_score(us, v, k, exclude=excl)
    for r in range(us.shape[0]):
        one = ops.topk_score(us[r:r + 1], v, k, exclude=excl[r:r + 1])
        for a, b in zip(got, one):
            if not torch.equal(a[r:r + 1].view(torch.int32),
                               b.view(torch.int32)):
                raise AssertionError(f"topk_score {label}: B="
                                     f"{us.shape[0]} differs from B=1 "
                                     "calls")


def time_topk(us, v, k, excl, label):
    """The kernel's time a call, its scoring and selection passes apart
    (over one scratch), one library expression's and the bound; prints
    them and returns the numbers of the kernels line."""
    from repro_torch.kernels import topk_score as ktopk
    B, S, K = us.shape
    N = v.shape[1]
    ms = time_ms(lambda: ktopk.topk_score_cuda(us, v, excl, k))
    queued = queued_ms(lambda: ktopk.topk_score_cuda(us, v, excl, k))
    bufs = ktopk.launch(us, v, excl, k)
    t0 = time.perf_counter()
    for _ in range(100):        # checks, plan, the C entry; no kernel
        ktopk.launch(us, v, excl, k, 0, bufs)
    host = (time.perf_counter() - t0) * 10
    scoring = time_ms(lambda: ktopk.launch(us, v, excl, k, 1, bufs))
    selection = time_ms(lambda: ktopk.launch(us, v, excl, k, 2, bufs))
    lib = time_ms(lambda: library_topk(us, v, k, excl))
    b_ms, b_by = topk_bound(B, S, N, K, k)
    plan = ktopk.plan(B, N, k, _n_sm())
    items = S * N * K * 4
    print(f"  topk_score {label} k={k}: {ms:.3f} ms a call ({queued:.3f} "
          f"ms a call queued back to back; host work {host:.3f} ms a "
          "call), library "
          f"(einsum + moments + torch.topk) {lib:.3f} ms, bound {b_ms:.3f} "
          f"ms by {b_by} ({items / 1e9:.3f} GB of items), {b_ms / ms:.3f} "
          f"of it; scoring pass {scoring:.4f} ms ({items / scoring / 1e6:.0f}"
          f" GB/s of items, one read a group of {ktopk.GROUP} users), "
          f"selection pass {selection:.4f} ms; plan: {plan.tn} items a "
          f"scoring block, {plan.route} route, {plan.lists} lists, "
          f"{plan.merges} merge rounds")
    return {"ms": ms, "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}


def _n_sm() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def write_store(directory, n_users: int, n_items: int, nsamples: int,
                seed: int, device="cuda"):
    """A posterior-sample store of ``nsamples`` seeded N(0, 1) factor
    draws at K = 128, written by the port's session saver
    (``checkpoint/ckpt.py``): ``model.json`` and one sample a step.
    The block holds 8 distinct items a user."""
    import numpy as np
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder, from_coo
    from repro_torch.core.gibbs import init_state
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_users), 8)
    cols = (rows * 997 + np.tile(np.arange(8) * 1021, n_users)) % n_items
    vals = rng.normal(size=rows.size).astype(np.float32)
    train = from_coo(rows, cols, vals, (n_users, n_items), device=device)
    b = ModelBuilder(num_latent=128, device=device)
    b.add_entity("compound", n_users)
    b.add_entity("protein", n_items)
    b.add_block("compound", "protein", train, noise=AdaptiveGaussian())
    sess = b.session(burnin=0, nsamples=nsamples, seed=seed, save_freq=1,
                     save_dir=directory)
    state = init_state(sess.model, sess.data, seed)
    saver = sess._make_saver()
    gen = torch.Generator(device=device).manual_seed(seed)
    for s in range(nsamples):
        factors = tuple(torch.randn(n, 128, device=device, generator=gen)
                        for n in (n_users, n_items))
        saver.save(s + 1, state._replace(factors=factors, step=s + 1))
    saver.wait()


def serve_store512(seed: int):
    """``PredictSession.recommend_rows`` from a store of 512 samples at
    K = 128, which the first design refused (S * K above its shared
    memory): 8 compounds at k = 100 and k = 2,048, each held bitwise
    against B = 1 calls and against the plain version; the kernel's
    times at that shape."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import PredictSession
    from repro_torch.kernels import ops, ref
    n_users, n_items, nsamples = STORE512
    block = ("compound", "protein")
    store = tempfile.mkdtemp(prefix="chip_smoke_store512_")
    try:
        t0 = time.perf_counter()
        write_store(store, n_users, n_items, nsamples, seed)
        on_disk = sum(f.stat().st_size for f in Path(store).rglob("*")
                      if f.is_file())
        print(f"store of {nsamples} samples at K=128 ({n_users} compounds "
              f"x {n_items} proteins) written in "
              f"{time.perf_counter() - t0:.2f} s, {on_disk / 1e9:.3f} GB "
              "on disk")
        sess = PredictSession(store, cache_bytes=SERVE_CACHE_BYTES)
        rng = np.random.default_rng(seed + 2)
        users = rng.choice(n_users, SERVE_SLOTS, replace=False)
        excl = [np.sort(rng.choice(n_items, 64, replace=False))
                for _ in users]
        rows = sess.user_rows(users, block)
        sess.warm_cache()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        recs = {k: sess.recommend_rows(rows, k=k, block=block,
                                       exclude=excl)
                for k in (SERVE_K, STORE512_K)}
        wall = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        want = {"gram": 0, "sddmm": 0, "topk_score": 2, "flash": 0}
        if counts != want:
            raise AssertionError(f"store512: launch counts {counts}, want "
                                 f"{want}")
        print(f"store512: recommend_rows of {SERVE_SLOTS} compounds at "
              f"k={SERVE_K} and k={STORE512_K}: {wall:.1f} ms for both "
              f"(host clock), launches {counts}")
        v = sess.warm_cache().factors[1]
        mask = torch.from_numpy(sess._exclude_mask(
            excl, SERVE_SLOTS, n_items)).to("cuda")
        for k, rec in recs.items():
            label = (f"store512 B={SERVE_SLOTS} S={nsamples} N={n_items} "
                     f"K=128 k={k}")
            got = [torch.from_numpy(x).to("cuda")
                   for x in (rec.ids, rec.mean, rec.std)]
            dm, ds = ref.check_topk_score(got, plain_topk(rows, v, k, mask),
                                          rows, v, f"topk_score {label}")
            for r, u in enumerate(users):
                one = sess.recommend_rows(rows[r:r + 1], k=k, block=block,
                                          exclude=[excl[r]])
                for key in ("ids", "mean", "std"):
                    if not same_bits(getattr(rec, key)[r],
                                     getattr(one, key)[0]):
                        raise AssertionError(f"{label}: {key} of compound "
                                             f"{u} differs from a B=1 call")
                if np.isin(rec.ids[r], excl[r]).any():
                    raise AssertionError(f"{label}: an excluded protein "
                                         "was recommended")
            print(f"  {label}: max |mean diff| {dm:.3e}, max |std diff| "
                  f"{ds:.3e} against the plain version; bitwise equal to "
                  f"{SERVE_SLOTS} calls with B=1")
            time_topk(rows, v, k, mask, f"store512 B={SERVE_SLOTS} "
                      f"S={nsamples} N={n_items} K=128")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def phase_serving(train, test, seed: int, gen):
    """The serving path: a store trained at the slice's width, reloaded
    by ``PredictSession`` and served through ``RecommendServer`` in both
    directions of the block; then the kernel against its plain version.
    Returns the ``topk_score`` entry of the kernels line."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder, PredictSession
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import RecommendServer
    from repro_torch.obs import Histogram, percentile_summary
    import topk_score_v1 as previous

    burnin, nsamples = SERVE_SWEEPS
    # the kernel's first call loads its library and its functions; a
    # server pays that once, at start-up, so it is timed apart
    t0 = time.perf_counter()
    ops.topk_score(torch.ones(1, 1, 4, device="cuda"),
                   torch.ones(1, 2000, 4, device="cuda"), 1)
    torch.cuda.synchronize()
    print(f"topk_score first call (library load, scoring and selection "
          f"kernels): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        ops.reset_launch_counts()
        b = ModelBuilder(num_latent=128)
        b.add_entity("compound", train.n_rows)
        b.add_entity("protein", train.n_cols)
        b.add_block("compound", "protein", train, test=test,
                    noise=AdaptiveGaussian())
        t0 = time.perf_counter()
        res = b.session(burnin=burnin, nsamples=nsamples, seed=seed,
                        save_freq=1, save_dir=store).run()
        train_s = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(store).rglob("*")
                      if f.is_file())
        print(f"store: {burnin} + {nsamples} sweeps with save_freq=1 in "
              f"{train_s:.2f} s (runtime_s {res.runtime_s:.3f}), "
              f"{on_disk / 1e9:.3f} GB on disk, rmse_test "
              f"{res.rmse_test:.6f}")

        sess = PredictSession(store, cache_bytes=SERVE_CACHE_BYTES)
        t0 = time.perf_counter()
        pred = sess.predict(test[0], test[1])
        reload_s = time.perf_counter() - t0
        if not np.isfinite(pred).all():
            raise AssertionError("serving: non-finite reloaded predictions")
        np.testing.assert_allclose(pred, res.predictions, **RELOAD_TOL,
                                   err_msg="serving: reload vs session")
        stats = sess.cache_stats()
        print(f"reload: PredictSession.predict at {pred.size} held-out "
              f"entries in {reload_s:.2f} s (the cache's warm included), "
              f"max |diff| vs the in-session mean "
              f"{np.abs(pred - res.predictions).max():.3e} ({RELOAD_TOL});"
              f" resident {stats['resident_bytes'] / 1e9:.3f} GB of "
              f"store_nbytes {sess.store_nbytes() / 1e9:.3f} GB, "
              f"{stats['load_count']} loads")
        if not sess.cache_resident or sess.load_count != nsamples:
            raise AssertionError(f"serving: cache not resident {stats}")
        del res, pred

        rng = np.random.default_rng(seed + 1)
        paths = []
        for label, block, padded, n_users in (
                ("compound -> proteins", ("compound", "protein"),
                 train.rows, train.n_rows),
                ("protein -> compounds", ("protein", "compound"),
                 train.cols, train.n_cols)):
            users = rng.choice(n_users, SERVE_REQUESTS, replace=False)
            excl = observed_items(padded, users)
            srv = RecommendServer(sess, slots=SERVE_SLOTS, k=SERVE_K,
                                  block=block)
            # the first step runs PyTorch kernels for the first time (the
            # gathers, the mask's copy, the finalize), which load then:
            # one request, timed apart, before the measured ones
            srv.submit(user=int(users[0]), exclude=excl[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.run()
            first_ms = (time.perf_counter() - t0) * 1e3
            srv.obs.reset()
            reqs = {srv.submit(user=int(u), exclude=e): (int(u), e)
                    for u, e in zip(users, excl)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = {r["id"]: r for r in srv.run()}
            wall = time.perf_counter() - t0
            hists = srv.metrics_snapshot()["histograms"]
            paths.append(dict(
                label=label, block=block, users=users, excl=excl,
                reqs=reqs, done=done, wall=wall, first_ms=first_ms,
                steps=Histogram.from_dict(
                    hists["serve.batch_occupancy"]).total,
                execute=percentile_summary(Histogram.from_dict(
                    hists["serve.execute_s"]))))
        counts = ops.launch_counts()
        sweeps = burnin + nsamples
        want = {"gram": 2 * sweeps, "sddmm": sweeps + 2 * nsamples,
                "topk_score": sum(p["steps"] + 1 for p in paths),
                "flash": 0}
        if counts != want:
            raise AssertionError(f"serving: launch counts {counts}, "
                                 f"want {want}")
        print(f"serving path launches {counts} (gram 2 per sweep; sddmm 1 "
              "per sweep, 1 per sample in the session and 1 per sample "
              "in the reload; topk_score 1 per server step, the first "
              "request's included)")

        # batching changes no answer
        for p in paths:
            for rid, (u, e) in p["reqs"].items():
                r = p["done"][rid]
                seq = sess.recommend(user=u, k=SERVE_K, block=p["block"],
                                     exclude=[e])
                for key in ("ids", "mean", "std"):
                    if not same_bits(r[key], getattr(seq, key)[0]):
                        raise AssertionError(
                            f"serving {p['label']}: request {rid} {key} "
                            "differs from a sequential recommend")
                if (r["ids"] < 0).any() or np.isin(r["ids"], e).any() \
                        or not np.isfinite(r["std"]).all():
                    raise AssertionError(f"serving {p['label']}: bad "
                                         f"answer for request {rid}")
            ex = p["execute"]
            print(f"  {p['label']}: first request {p['first_ms']:.1f} "
                  f"ms; then {SERVE_REQUESTS} requests, "
                  f"{SERVE_SLOTS} slots, k={SERVE_K}, {p['steps']} steps "
                  f"in {p['wall'] * 1e3:.1f} ms; serve.execute_s p50 "
                  f"{ex['p50'] * 1e3:.3f} ms, p99 {ex['p99'] * 1e3:.3f} ms; "
                  f"mean exclusions a query "
                  f"{np.mean([len(e) for e in p['excl']]):.1f}; every "
                  "answer bitwise equal to a sequential recommend")

        for p in paths:
            step_breakdown(sess, p)

        # the kernel against its plain version
        print(f"topk_score tolerance: mean rtol {ref.TOPK_MEAN_RTOL} of "
              f"(1/S) sum |u||v|, std {ref.TOPK_STD_RTOL} * sqrt(ex2), ids "
              "equal but at near-ties (kernels/ref.py states why)")
        errs = []

        def check(us, v, k, excl, label):
            got = ops.topk_score(us, v, k, exclude=excl)
            torch.cuda.synchronize()
            dm, ds = ref.check_topk_score(got, plain_topk(us, v, k, excl),
                                          us, v, f"topk_score {label}")
            errs.append(dm)
            print(f"  topk_score {label}: max |mean diff| {dm:.3e}, max "
                  f"|std diff| {ds:.3e}")
            return got

        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        for label, (us_shape, v_shape, k) in \
                ops.KERNELS["topk_score"].items():
            excl = (torch.rand(us_shape[0], v_shape[1], device="cuda",
                               generator=gen) < 0.4).float() \
                if "exclusions" in label else None
            excl = ops.exclusion_mask(excl, us_shape[0], v_shape[1], "cuda")
            check(rand(*us_shape), rand(*v_shape), k, excl, label)
        # exact ties: items 4000.. duplicate items 0.. of the same stack
        us, v = rand(8, 32, 32), rand(32, 4096, 32)
        v[:, 4000:] = v[:, :96]
        excl = ops.exclusion_mask(None, 8, 4096, "cuda")
        ids = check(us, v, 1024, excl, "duplicated rows b8 n4096 k1024")[0]
        pairs = 0
        for row in ids.tolist():
            for d in range(4000, 4096):
                if d in row:
                    if row.index(d - 4000) > row.index(d):
                        raise AssertionError("topk_score: a duplicate "
                                             "ranked before its lower id")
                    pairs += 1
        if not pairs:
            raise AssertionError("topk_score: no tied pair was selected")
        print(f"  topk_score exact ties: {pairs} duplicated pairs, each "
              "lowest id first")

        cache = sess.warm_cache()
        shapes = []
        for p in paths:
            us = sess.user_rows(p["users"][:SERVE_SLOTS], p["block"])
            _, ie = sess._block_entities(p["block"])
            v = cache.factors[ie]
            excl = torch.zeros((SERVE_SLOTS, v.shape[1]), device="cuda")
            for r, e in enumerate(p["excl"][:SERVE_SLOTS]):
                excl[r, torch.as_tensor(e, device="cuda").long()] = 1.0
            shapes.append((p["label"], us, v, excl))
        # k above 1,024 (the radix route) and k = N, N = 8,192 proteins
        label, us, v, excl = shapes[0]
        for k in (STORE512_K, v.shape[1]):
            lab = f"{label} B={SERVE_SLOTS} N={v.shape[1]} k={k}"
            check(us, v, k, excl, lab)
            same_as_single_calls(us, v, k, excl, lab)
            print(f"  topk_score {lab}: bitwise equal to {SERVE_SLOTS} "
                  "calls with B=1")

        entry = {"name": "topk_score", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/topk_score.cu",
                 "replaces": "src/repro/kernels/topk_score.py:139",
                 "launches": counts["topk_score"], "ms": 0.0,
                 "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                 "previous_ms": 0.0, "previous_source": PREVIOUS_TOPK}
        by = {"bytes": 0.0, "operations": 0.0}
        for label, us, v, excl in shapes:
            S, N, K = v.shape
            label = f"{label} B={SERVE_SLOTS} S={S} N={N} K={K}"
            check(us, v, SERVE_K, excl, label)
            same_as_single_calls(us, v, SERVE_K, excl, label)
            prev_out = ops.finalize_topk(*previous.topk(us, v, excl,
                                                        SERVE_K), excl)
            ref.check_topk_score(prev_out, plain_topk(us, v, SERVE_K, excl),
                                 us, v, f"first-design topk_score {label}")
            t = time_topk(us, v, SERVE_K, excl, label)
            prev = time_ms(lambda: previous.topk(us, v, excl, SERVE_K))
            plain = time_ms(lambda: ref.topk_score_ref(us, v, excl,
                                                       SERVE_K))
            print(f"  topk_score {label}: first design "
                  f"({PREVIOUS_TOPK}) {prev:.3f} ms, this one {t['ms']:.3f}"
                  f" ({prev / t['ms']:.2f}x); plain {plain:.3f} ms; "
                  f"bitwise equal to {SERVE_SLOTS} calls with B=1")
            for key, val in (("ms", t["ms"]), ("plain_ms", plain),
                             ("library_ms", t["library_ms"]),
                             ("bound_ms", t["bound_ms"]),
                             ("previous_ms", prev)):
                entry[key] += val
            by[t["bound_by"]] += t["bound_ms"]
        entry["bound_by"] = max(by, key=by.get)
        entry["max_abs_err"] = max(errs)
        print(f"  topk_score, one call at each path shape: "
              f"{entry['ms']:.3f} ms (first design {entry['previous_ms']:.3f}"
              f"), bound {entry['bound_ms']:.3f} ms")
        del sess, cache, shapes, us, v, excl
        torch.cuda.empty_cache()
        serve_store512(seed)
        return entry
    finally:
        shutil.rmtree(store, ignore_errors=True)


# the LM slice: Qwen3-4B at full width and depth, random weights
LM_ARCH = "qwen3_4b"
LM_PREFILL = (4, 4096)      # prompts x tokens: train_4k's sequence length
LM_GEN = (8, 128, 32)       # prompts, prompt tokens, new tokens
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS = 8, 512, 16
LM_TOL = dict(rtol=0.08, atol=0.08)   # decode vs forward, test_models.py


def flash_bound(q_shape, kv_shape):
    """(ms, by, operations) of one causal bf16 call from position 0:
    q, k, v read once, out written once; 4 hd operations per visible
    (query, key) pair and head, at the tensor cores' bf16 rate."""
    B, Sq, H, hd = q_shape
    Sk, KVH = kv_shape[1], kv_shape[2]
    pairs = sum(min(Sk, s + 1) for s in range(Sq))
    n_bytes = 2 * (2 * B * Sq * H * hd + 2 * B * Sk * KVH * hd)
    n_ops = 4 * B * H * hd * pairs
    return bound(n_bytes, n_ops, PEAK_BF16_FLOPS) + (n_ops,)


def sdpa(q, k, v):
    """PyTorch's fused attention on the same inputs, the yardstick
    (causal from position 0, Sq = Sk, GQA)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def phase_flash(gen):
    """The flash kernels against their plain version at the reference's
    probes, ragged cases, GQA groups of 3 and 1 at hd 64 and the prefill
    shape at B = 1, each through the design that ``flash.design`` routes
    it to (and the probe and ragged shapes again in bf16 at hd 128, on
    flash_sm90); then, in turns within this call at the forward's shape
    (B = 4): flash_sm90, the PR-14 kernel of flash.cu, SDPA and the plain
    version.  Returns the kernels-line entry without launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ops, ref
    errs = []
    print(f"flash tolerance: rtol {ref.FLASH_RTOL[torch.float32]} (fp32), "
          f"{ref.FLASH_RTOL[torch.bfloat16]} (bf16) of |plain| + sum p|v| "
          "(kernels/ref.py states why)")
    for line in _build.build_log("flash_sm90").splitlines():
        if "registers" in line or "spill" in line or "C75" in line:
            print(f"  ptxas flash_sm90: {line.strip()}")

    def rand(shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    B, S = LM_PREFILL
    bf16 = torch.bfloat16
    ragged = ((2, 130, 4, 16), (2, 257, 2, 16),
              dict(causal=True, window=96, q_offset=100))
    cases = [(label, q, kv, dt, kw)
             for label, (q, kv, dt, kw) in ops.KERNELS["flash"].items()]
    cases += [("ragged sq130 sk257 offset 100 window 96", *ragged[:2], dt,
               ragged[2]) for dt in (torch.float32, bf16)]
    # the same shapes at the Hopper design's head widths
    cases += [(label + " at hd128", q[:3] + (128,), kv[:3] + (128,), bf16,
               kw) for label, q, kv, _, kw in cases[:1]]
    cases += [("ragged sq130 sk257 offset 100 window 96 at hd128",
               ragged[0][:3] + (128,), ragged[1][:3] + (128,), bf16,
               ragged[2]),
              ("smollm G3 hd64 sq300 (900 rows)", (2, 300, 9, 64),
               (2, 300, 3, 64), bf16, dict(causal=True)),
              ("whisper G1 hd64 sq150 sk190 noncausal", (2, 150, 16, 64),
               (2, 190, 16, 64), bf16, dict(causal=False)),
              ("whisper G1 hd64 sq150 causal", (2, 150, 16, 64),
               (2, 150, 16, 64), bf16, dict(causal=True)),
              (f"prefill b1 s{S} h32/8 hd128", (1, S, 32, 128),
               (1, S, 8, 128), bf16, dict(causal=True))]
    for label, q_shape, kv_shape, dt, kw in cases:
        q, k, v = (rand(s, dt) for s in (q_shape, kv_shape, kv_shape))
        before = dict(kflash.design_launches)
        out = kflash.flash_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        src = [n for n, c in kflash.design_launches.items()
               if c != before[n]]
        if src != [kflash.design(dt, q_shape[3])]:
            raise AssertionError(f"flash {label}: launched {src}")
        e = ref.check_attention(out, q, k, v, **kw, what=f"flash {label}")
        errs.append(e)
        print(f"  flash {label} {str(dt)[6:]} on {src[0]}: max abs err "
              f"{e:.3e}")
        del q, k, v, out
    torch.cuda.empty_cache()

    q_shape, kv_shape = (B, S, 32, 128), (B, S, 8, 128)
    q, k, v = (rand(s, bf16) for s in (q_shape, kv_shape, kv_shape))
    fns = {"flash_sm90": lambda: kflash.launch("flash_sm90", q, k, v,
                                               causal=True),
           "flash (PR 14)": lambda: kflash.launch("flash", q, k, v,
                                                  causal=True),
           "SDPA": lambda: sdpa(q, k, v),
           "plain": lambda: ref.attention_ref(q, k, v, causal=True)}
    # in turns: each timed twice, the second round in reverse order
    times = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            times[n].append(time_ms(fns[n], n=5 if n == "plain" else 20))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    b_ms, b_by, n_ops = flash_bound(q_shape, kv_shape)
    print(f"  flash at the forward's shape b{B} s{S} h32/8 hd128 bf16 "
          f"causal, bound {b_ms:.3f} ms by {b_by} ({n_ops / 1e9:.1f} GFLOP); "
          "two rounds in turns, mean:")
    for n, t in times.items():
        print(f"    {n}: {ms[n]:.3f} ms ({', '.join(f'{x:.3f}' for x in t)})"
              f", {n_ops / ms[n] / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms[n]:.3f} of the bound")
    print(f"  flash_sm90 / PR-14 kernel {ms['flash_sm90'] / ms['flash (PR 14)']:.3f}"
          f", flash_sm90 / SDPA {ms['flash_sm90'] / ms['SDPA']:.3f}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": "flash", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_sm90.cu",
            "replaces": "src/repro/kernels/flash.py:129",
            "max_abs_err": max(errs), "ms": ms["flash_sm90"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms["SDPA"], "previous_ms": ms["flash (PR 14)"],
            "previous_source": "src/repro_torch/kernels/csrc/flash.cu"}


def profile_once(fn, label):
    """fn() under torch.profiler: wall, device busy, idle share and the
    kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    if not 0 < busy <= wall:
        raise AssertionError(f"{label} profile: busy {busy} of {wall} ms")
    print(f"  profile, {label}: {wall:.1f} ms wall (profiler on), device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}; by kernel:")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


def phase_lm(seed: int, flash_entry):
    """The LM serving path at Qwen3-4B's full width and depth."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as tserve
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.obs import Histogram, percentile_summary

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; {param_count(cfg)[0]:,} "
          f"parameters, {held / 1e9:.2f} GB held in "
          f"{cfg.dtype}; random weights from seed {seed} drawn on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    stream = TokenStream(cfg.vocab_size, seed)

    # forward: B x S prompts; the first call captures the first and last
    # layers' attention inputs by wrapping ops.flash_attention
    B, S = LM_PREFILL
    toks = torch.from_numpy(stream.batch(0, B, S)[:, :S]).cuda()
    captured, calls = {}, [0]
    orig = ops.flash_attention

    def spy(q, k, v, **kw):
        if calls[0] in (0, cfg.n_layers - 1):
            captured[calls[0]] = (q.clone(), k.clone(), v.clone(), kw)
        calls[0] += 1
        return orig(q, k, v, **kw)

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention = spy
    try:
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.flash_attention = orig
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} "
                             f"{logits.dtype} not finite or not of shape")
    del logits
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    n_fwd = 4
    if ops.launch_counts()["flash"] != cfg.n_layers * n_fwd or \
            kflash.design_launches != {"flash_sm90": cfg.n_layers * n_fwd,
                                       "flash": 0}:
        raise AssertionError(f"forward: {ops.launch_counts()} flash launches "
                             f"({kflash.design_launches} by source) in "
                             f"{n_fwd} forwards, want {cfg.n_layers} each, "
                             "all on flash_sm90")
    med = statistics.median(fwd_ms)
    print(f"forward B={B} S={S}: first {first_ms:.1f} ms, then "
          + ", ".join(f"{t:.1f}" for t in fwd_ms) + f" ms (median {med:.1f} "
          f"ms, {B * S / med * 1e3:.0f} tokens/s); peak device memory "
          f"{peak / 1e9:.2f} GB; flash launches "
          f"{ops.launch_counts()['flash']} in {n_fwd} forwards, by source "
          f"{kflash.design_launches}")

    # generate: greedy; every serve_step timed and its logits kept for
    # the prompt positions, by wrapping the module's serve_step
    nb, s0, max_new = LM_GEN
    prompts = stream.batch(1, nb, s0)[:, :s0]
    orig_step = tserve.serve_step
    step_ms, dec = [], []

    def timed_step(*a, **kw):
        t = time.perf_counter()
        lg, c = orig_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if len(dec) < s0:
            dec.append(lg[:, 0])
        return lg, c

    tserve.serve_step = timed_step
    try:
        t0 = time.perf_counter()
        gen_toks = tserve.generate(cfg, model, prompts, max_new=max_new)
        gen_s = time.perf_counter() - t0
    finally:
        tserve.serve_step = orig_step
    if gen_toks.shape != (nb, s0 + max_new) or not (
            (gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all():
        raise AssertionError(f"generate: tokens {gen_toks.shape} out of range")
    replay, decode = step_ms[:s0], step_ms[s0:s0 + max_new]
    print(f"generate B={nb}, {s0} prompt + {max_new} new tokens: "
          f"{gen_s:.2f} s; serve_step median {statistics.median(replay):.2f}"
          f" ms (prompt replay) and {statistics.median(decode):.2f} ms "
          f"(decode; p90 {np.percentile(decode, 90):.2f}), "
          f"{nb / statistics.median(decode) * 1e3:.0f} tokens/s")
    par, _ = forward(model, cfg, {"tokens": prompts})
    dec = torch.stack(dec, 1)
    diff = (dec.float() - par.float()).abs()
    within = float((diff <= LM_TOL["atol"] + LM_TOL["rtol"]
                    * par.float().abs()).float().mean())
    # bf16 logits over 151,936 tokens tie exactly in a few percent of
    # rows, where the first-index argmax is an arbitrary pick: the
    # agreement held is that decode's choice is a maximiser of the
    # forward's logits (the first-index agreement is printed beside it)
    first = float((dec.argmax(-1) == par.argmax(-1)).float().mean())
    top = par.max(-1).values
    agree = float((par.gather(-1, dec.argmax(-1, keepdim=True))[..., 0]
                   == top).float().mean())
    top2 = par.float().topk(2, dim=-1).values
    ties = float((top2[..., 0] == top2[..., 1]).float().mean())
    print(f"decode vs forward at all {nb} x {s0} prompt positions: decode's "
          f"argmax a maximiser of forward's logits in {agree:.4f} of rows "
          f"(first-index argmax agreement {first:.4f}; rows whose top two "
          f"forward logits tie exactly in bf16 {ties:.4f}); max |diff| "
          f"{diff.max().item():.4f}, median |diff| "
          f"{diff.median().item():.5f}, share of logits within rtol/atol "
          f"0.08 {within:.6f}; forward logits std "
          f"{par.float().std().item():.3f}")
    if not agree > 0.95:
        raise AssertionError(f"decode vs forward: argmax agreement {agree}")
    del par, dec, diff

    # BatchedServer: the same prompts admitted at once, then 16 requests
    srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in srv.run()}
    got = np.asarray([done[i]["generated"] for i in ids], np.int32)
    if not np.array_equal(got, gen_toks[:, s0:]):
        raise AssertionError("BatchedServer: the 8 answers differ from "
                             "generate's tokens")
    print(f"BatchedServer, {LM_SLOTS} slots, max_len {LM_MAX_LEN}: the {nb} "
          "prompts admitted together answer generate's tokens, bitwise")
    del srv
    srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
    reqs = stream.batch(2, LM_REQUESTS, s0)[:, :s0]
    for p in reqs:
        srv.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    wall = time.perf_counter() - t0
    hists = srv.metrics_snapshot()["histograms"]
    ex = percentile_summary(Histogram.from_dict(hists["serve.execute_s"]))
    steps = Histogram.from_dict(hists["serve.batch_occupancy"]).total
    n_new = sum(len(r["generated"]) for r in done)
    if len(done) != LM_REQUESTS or n_new != LM_REQUESTS * max_new:
        raise AssertionError(f"BatchedServer: {len(done)} done, {n_new} "
                             "tokens")
    print(f"BatchedServer, {LM_REQUESTS} requests of {s0} + {max_new} "
          f"tokens through {LM_SLOTS} slots: {steps} steps in {wall:.2f} s, "
          f"{n_new / wall:.1f} generated tokens/s; serve.execute_s p50 "
          f"{ex['p50'] * 1e3:.1f} ms, p99 {ex['p99'] * 1e3:.1f} ms")
    counts = ops.launch_counts()
    # forwards: the timed ones, generate's prefill and the one decode is
    # held against
    want = {"gram": 0, "sddmm": 0, "topk_score": 0,
            "flash": cfg.n_layers * (n_fwd + 2)}
    if counts != want or kflash.design_launches["flash_sm90"] != want["flash"]:
        raise AssertionError(f"lm: launch counts {counts} "
                             f"({kflash.design_launches} by source), want "
                             f"{want}, all flash on flash_sm90")
    print(f"lm path launches {counts} ({cfg.n_layers} per forward: {n_fwd} "
          "timed forwards, generate's prefill and the forward decode is "
          "held against; decode runs no flash kernel)")

    # where a forward and a decode step spend the card's time
    profile_once(lambda: forward(model, cfg, {"tokens": toks}),
                 f"one forward B={B} S={S}")
    caches = tserve.init_serve_cache(model, cfg, nb, s0 + max_new,
                                     prefilled=s0)
    step1 = prompts[:, :1]
    profile_once(lambda: tserve.serve_step(model, cfg, caches, step1),
                 f"one decode step B={nb} at position {s0}")
    del caches

    # the kernel against its plain version at captured layers
    for layer, (q, k, v, kw) in sorted(captured.items()):
        out = orig(q, k, v, **kw)
        torch.cuda.synchronize()
        e = ref.check_attention(out, q, k, v, **kw,
                                what=f"flash at layer {layer}")
        flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"], e)
        print(f"  flash at layer {layer}'s captured inputs "
              f"{tuple(q.shape)}: max abs err {e:.3e}")
    flash_entry["launches"] = counts["flash"]
    return flash_entry


def busy_ms(events) -> float:
    """Time in ms that at least one device activity of ``events`` (the
    profiler's FunctionEvents) was running: the union of their
    intervals, so overlapping activities count once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def phase_profile(sess, res, sweep_ms):
    """One more sweep under torch.profiler: the device's idle share and
    device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import gibbs_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gibbs_step(sess.model, sess.data, res.state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    busy = busy_ms(prof.events())
    if not 0 < busy <= wall:
        raise AssertionError(f"profile: device busy {busy:.3f} ms in a "
                             f"sweep of {wall:.3f} ms wall")
    # the profiler slows the host, not the kernels: the busy time set
    # against the unprofiled sweeps' wall is the share without it
    plain_wall = statistics.median(sweep_ms[1:])
    print(f"profile: one sweep {wall:.1f} ms wall (profiler on), device "
          f"busy {busy:.1f} ms (union of kernel and copy intervals), idle "
          f"share {1 - busy / wall:.3f} with the profiler on, "
          f"{1 - busy / plain_wall:.3f} against the median unprofiled "
          f"sweep ({plain_wall:.1f} ms)")
    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA]
    print("  by operation (device time of the kernels each launched):")
    ops_ = [e for e in stats if e.device_type != DeviceType.CUDA
            and e.key.startswith("aten::") and e.device_time_total > 0]
    ops_.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in ops_[:12]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key}")
    print("  by kernel:")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    # gram gathers in its loads and folds alpha and Lambda_p into its
    # epilogue: the sweep's only gathers are sddmm's two
    counts = {e.key: e.count for e in stats}
    largest = {k: max((e.device_time_total / 1e3 for e in ops_
                       if e.key == k), default=0.0)
               for k in ("aten::mul_", "aten::add_")}
    print(f"  gram's pipeline: aten::index_select x"
          f"{counts.get('aten::index_select', 0)} (sddmm's U and V rows); "
          + ", ".join(f"{k} x{counts.get(k, 0)}, {v:.3f} ms in all"
                      for k, v in largest.items()))
    if counts.get("aten::index_select", 0) != 2:
        raise AssertionError(f"profile: {counts.get('aten::index_select')} "
                             "index_select in a sweep, want sddmm's 2")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the slice's data and of the chain")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_file() \
            or not (ROOT / PREVIOUS_TOPK).is_file() \
            or not (ROOT / PREVIOUS_GRAM).is_file():
        print("chip_smoke: run it from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "scripts_dev"))

    print("== card")
    phase_card()
    print(f"== data: {COMPOUNDS} compounds x 8192 proteins, seed "
          f"{args.seed}")
    t0 = time.perf_counter()
    train, test = slice_data(COMPOUNDS, args.seed, "cuda")
    print(f"data: {int(train.nnz)} training entries, {test[0].size} "
          f"test entries, row T={train.rows.max_nnz}, col "
          f"T={train.cols.max_nnz}, {time.perf_counter() - t0:.1f} s")
    print("== kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = phase_kernels(train, gen)
    print("== golden chain")
    phase_golden()
    print("== slice")
    burnin, nsamples = SWEEPS
    sess, res, counts, sweep_ms = phase_slice(train, test, burnin,
                                              nsamples, args.seed)
    print("== profile")
    phase_profile(sess, res, sweep_ms)
    del sess, res
    print("== witness: the test predictions where the model is well posed")
    phase_witness(train, test, args.seed)
    torch.cuda.empty_cache()
    print("== serving: store, PredictSession, RecommendServer, topk_score")
    topk = phase_serving(train, test, args.seed, gen)
    del train, test
    torch.cuda.empty_cache()
    print("== lm: flash, Qwen3-4B forward, generate, BatchedServer")
    flash = phase_lm(args.seed, phase_flash(gen))

    for name, entry in entries.items():
        entry["launches"] = counts[name]
    print(json.dumps({"kernels": [entries["gram"], entries["sddmm"],
                                  topk, flash]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
