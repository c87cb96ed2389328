#!/usr/bin/env python3
"""Run the PyTorch port of SMURFF on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

From the root of a checkout, on a machine with one NVIDIA H100:

1. card: prints the ``nvidia-smi`` name and power limit, and builds the
   CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. kernels: holds each kernel against its plain PyTorch version at the
   reference's probe shapes and at the shapes of the main path, and
   times kernel, plain version and one library call (CUDA events,
   median of 20 launches);
3. golden chain: replays the ``gaussian`` chain of
   ``results/golden_chains.json`` on the card;
4. slice: runs ``ModelBuilder(num_latent=128)`` -> ``session(...).run()``
   on a ChEMBL-shaped matrix (131,072 compounds x 8,192 proteins, 64
   proteins per compound, a planted rank-16 signal plus 0.3 noise, and
   a 10% held-out test set) and reads the kernels' launch counts;
5. profile: one more sweep under ``torch.profiler``, the device's
   idle share and device time by kernel;
6. witness: the same data at K = 16, the planted rank, for 30 sweeps;
   the test RMSE must fall below twice the planted noise.

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

# H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the slice: bmf_chembl's widths with the compounds cut to one card
COMPOUNDS = 131072
SWEEPS = (4, 2)   # burn-in, posterior samples
NOISE = 0.3       # sd of the Gaussian noise on the planted signal
WITNESS_SWEEPS = (20, 10)

GRAM_TOL = dict(rtol=1e-5, atol=1e-4)
SDDMM_TOL = dict(rtol=1e-5, atol=1e-5)
TOL_REASON = ("fp32 on both sides, summed in another order: the kernel "
              "walks t (gram) or k (sddmm) in its own order, the plain "
              "version through cuBLAS.  The rounding error of a sum "
              "grows with the sum of its terms' magnitudes, so rtol "
              "applies to that sum, the same function of |inputs|: "
              "|kernel - plain| <= atol + rtol * f(|inputs|)")


def bound(n_bytes: float, n_ops: float):
    """(ms, 'bytes'|'operations'): the least time on the card."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
          + ", ".join(f"{k} {v:.2f} s"
                      for k, v in sorted(_build.build_seconds.items())))
    for name in ("gram", "sddmm"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return smi


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

    for label, (R, T, k) in ops.KERNELS["gram"].items():
        mask = (torch.rand(R, T, device=dev, generator=gen) > 0.2).float()
        check_gram(rand(R, T, k), rand(R, T), mask, label)
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

    # timing at the main path's shapes: both gram launches of a sweep;
    # the bound is the sum of each launch's own bound
    gram_t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "bound_by": {"bytes": 0.0, "operations": 0.0}}
    for name, padded, fixed in (("rows", train.rows, V),
                                ("cols", train.cols, U)):
        vg, val, mask = slab(padded, fixed)
        label = f"{name} R={vg.shape[0]} T={vg.shape[1]} K={K}"
        check_gram(vg, val, mask, f"main path {label}")
        R, T, _ = vg.shape
        nnz = float(mask.sum())
        n_bytes = 4 * (nnz * K + 2 * R * T + R * K * K + R * K)
        # the Gram is symmetric: its lower triangle is K(K+1)/2 FMAs per
        # entry; the rhs is K more
        n_ops = nnz * K * (K + 1) + 2 * nnz * K
        ms = time_ms(lambda: kgram.gram_cuda(vg, val, mask))
        plain = time_ms(lambda: ref.gram_ref(vg, val, mask))
        vgm = vg * mask[..., None]
        lib = time_ms(lambda: torch.bmm(vgm.mT, vg))
        del vgm
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"  gram {label}: {ms:.3f} ms, plain {plain:.3f} ms, "
              f"torch.bmm (Gram only, pre-masked) {lib:.3f} ms, bound "
              f"{b_ms:.3f} ms by {b_by} ({n_ops / 1e9:.1f} GFLOP, "
              f"{n_bytes / 1e9:.2f} GB), {n_ops / ms / 1e9:.1f} TFLOP/s, "
              f"{n_bytes / ms / 1e6:.0f} GB/s")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms)):
            gram_t[key] += v
        gram_t["bound_by"][b_by] += b_ms
        del vg, val, mask
        torch.cuda.empty_cache()

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

    # the launch whose bound weighs most names what bounds the pair
    g_by = max(gram_t["bound_by"], key=gram_t["bound_by"].get)
    print(f"  gram, both launches: {gram_t['ms']:.3f} ms, bound "
          f"{gram_t['bound_ms']:.3f} ms ("
          + ", ".join(f"{v:.3f} by {k}"
                      for k, v in gram_t["bound_by"].items()) + ")")
    return {
        "gram": {
            "name": "gram", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gram.cu",
            "replaces": "src/repro/kernels/gram.py:83",
            "max_abs_err": errs["gram"], "ms": gram_t["ms"],
            "plain_ms": gram_t["plain_ms"], "bound_ms": gram_t["bound_ms"],
            "bound_by": g_by, "library_ms": gram_t["library_ms"]},
        "sddmm": {
            "name": "sddmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sddmm.cu",
            "replaces": "src/repro/kernels/sddmm.py:53",
            "max_abs_err": errs["sddmm"], "ms": s_ms, "plain_ms": s_plain,
            "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": s_lib},
    }


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
    want = {"gram": 2 * sweeps, "sddmm": sweeps + nsamples}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the slice's data and of the chain")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_file():
        print("chip_smoke: run it from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

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

    for name, entry in entries.items():
        entry["launches"] = counts[name]
    print(json.dumps({"kernels": [entries["gram"], entries["sddmm"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
