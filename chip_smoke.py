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
   shapes and timed beside it, part by part; sddmm's fused-gather
   entries (the sweeps' predictions at gathered rows, and at every slot
   of probit's padded rows and columns) likewise, bitwise against
   ``index_select`` x 2 + ``sddmm_f32`` and against the entry's first
   design ``scripts_dev/sddmm_v1.cu``, timed beside both (the observed
   entries also in random order), with the bytes the design's model
   says it reads an entry over the measured time;
3. golden chains: replays the ``gaussian``, ``probit`` and ``gfa``
   chains of ``results/golden_chains.json`` on the card, through the
   engine and through the session wrappers (``TrainSession``,
   ``GFASession(zero_init_loadings=False)``), bitwise each other;
4. slice: runs ``ModelBuilder(num_latent=128)`` -> ``session(...).run()``
   on a ChEMBL-shaped matrix (131,072 compounds x 8,192 proteins, 64
   proteins per compound, a planted rank-16 signal plus 0.3 noise, and
   a 10% held-out test set) and reads the kernels' launch counts;
5. profile: one more sweep under ``torch.profiler``, the device's
   idle share and device time by kernel;
6. witness: the same data at K = 16, the planted rank, for 30 sweeps;
   the test RMSE must fall below twice the planted noise;
6b. bf16_gather: the bf16 branches the reference's ``bf16_gather``
   sweep reaches (``gram_gathered_bf16``, ``sddmm_bf16``,
   ``sddmm_gathered_bf16``, ``sddmm_padded_mixed`` for probit,
   ``sddmm_padded_bf16`` for the distributed residuals) against their
   plain versions at the probes in bf16 and at the slice's shapes, each
   fused entry bitwise the pipeline it replaces, timed beside the plain
   version, the pipeline and the fp32 entry; ``ModelBuilder(num_latent=
   128, bf16_gather=True)`` on the slice for 2 + 4 sweeps (median sweep
   and peak beside the fp32 slice's, the launches by entry: the bf16
   entries on the path, the fp32 gathered ones at 0, one profiled
   sweep); the K = 16 witness in bf16 (test RMSE within 10% of fp32's);
   probit at 16,384 compounds through the mixed padded entry; the ptxas
   lines of every bf16 instance (a spill of one the path runs fails);
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
   against the plain version; ``topk_score_bf16`` at both serving
   shapes on bf16 copies of the stored stacks (against its plain
   version, bitwise the fp32 kernel on the widened copies and B = 1
   calls, timed);
8. macau (``macau_chembl``): the slice's compounds and widths with
   2,048-bit side information (about 50 bits a compound, a planted
   link) through ``add_entity(side_info=)``; a save_freq store, its
   reload, ``predict_new`` for 1,024 held-out compounds (held against
   the fp64 formula) and 64 cold-start requests through
   ``RecommendServer(features=)``, each bitwise a sequential
   ``recommend(features=)``; the Macau hyper-sample timed alone;
9. probit (``probit_chembl``): the slice's entries as binary
   activities through probit noise;
10. dense (``dense_views``): one fully observed 131,072 x 4,096 block,
    K = 128, the shared-Gram path;
11. gfa (``gfa_views``): 131,072 samples with FixedNormal priors
    against views of 8,192, 4,096 and 2,048 features with
    spike-and-slab loadings, K = 32;
12. chains: two chains of the probit model at 16,384 compounds, each
    bitwise the single-chain run with its key;
13. sessions: the slice's data through ``TrainSession(num_latent=128,
    chains=2)`` into a two-chain store with a ``Recorder`` (each chain
    bitwise its single-chain run), the same run cut after one sample
    and resumed (bitwise), the store reloaded by ``PredictSession``, 16
    requests through ``RecommendServer`` from the pooled store, the
    trace's sweep spans and a recorder-off run (bitwise), and
    ``GFASession`` on ``gfa_views``' data for 1 + 1 sweeps;
14. distributed: a world of ``torch.cuda.device_count()`` ranks, one
    process a rank, NCCL (``repro_torch.runtime.run_world``), runs the
    slice at full width through ``make_distributed_step`` under eager and
    ring, 1 + 3 sweeps, beside the single-device sweep in the same rank
    (at one rank the first sweep bitwise it and ring's bitwise eager's;
    the fourth within 2e-4), probit at 16,384 compounds under eager,
    every sweep's collectives held against ``contract_for``, and
    ``TrainSession(mesh=...)`` 1 + 1 sweeps into a store that
    ``PredictSession`` reads, the slice with ``bf16_gather`` under eager
    and ring (the wire bf16 at ``contract_wire_bytes``); then probes
    whether gloo takes CUDA tensors (and bf16 ones) and, if it does,
    runs two ranks on the one card through gloo (eager, each rank's half
    of the rows at its offset; then bf16 under eager and ring);
15. lm: holds the ``flash`` kernels against their plain version at the
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
   same 8 prompts, bitwise ``generate``'s tokens; then 16 requests);
16. train: the flash forward's LSE output (both designs' out bitwise
    without it, out and lse held against the plain version's) at the
    probes and the training shape; the ``flash_bwd`` kernels against
    their plain version at the probes, at the training path's shape (8
    x 4,096, 9/3 heads of 64) and at Qwen3-4B's prefill shape (4 x
    4,096, 32/8 of 128), each through the design ``flash_bwd.design``
    routes it to (``flash_bwd_sm90`` for bf16 at 64/64, 128/128 and
    MLA's 192/128; its ptxas lines printed, a spill fails, and a wgmma
    of its 192/128 kernels serialised for want of registers, C7512,
    too), two calls bitwise, the path shapes also against the first
    design (``csrc/flash_bwd.cu``, which still serves fp32 and the other
    widths) within the same tolerance, and timed beside it, SDPA's
    backward and the plain version; its one-width instances against the
    one-width design's recorded bits (``ONE_WIDTH_SHA256``); its
    192/128 instance at ragged shapes and at DeepSeek-V2-Lite's prefill
    shape (4 x 4,096, 16 heads) and the MLA train phase's (2 x 4,096),
    held and timed the same ways; ``train`` on SmolLM-135M at full width and
    depth, 30 steps of 8 x 4,096 tokens (the loss must fall; 60 flash
    and 30 flash_bwd launches a step under remat, all flash_bwd on
    ``flash_bwd_sm90``; every step's time,
    the median and the whole window's rate), one step twice from one
    state (bitwise), n_micro=2's gradients against n_micro=1's, a
    profiled step, ``generate`` on the trained model against its
    cast-once bf16 copy (bitwise), and a 12-step run restarted after a
    lost device at step 10 against the uninterrupted run (bitwise);
16b. train dp: the same model and batch through
    ``make_sharded_train_step(variant="dponly")`` (replicated fp32
    parameters, ZeRO-1 moments, the batch split over the ranks): a world
    of ``torch.cuda.device_count()`` NCCL ranks for 3 steps (at one rank
    each bitwise the single-process step), then two gloo ranks on the
    one card, 4 x 4,096 tokens each, for 6 steps (the ranks bitwise
    equal after every step, each rank's ZeRO-1 update bitwise an
    unsharded ``adamw_update`` fed the same all-reduced gradients, each
    step's global loss (rtol 1e-3) and the first all-reduced gradient
    (by relative norm) against the single-process run's, both shown to
    refuse a planted fault (rank 1's rows dropped), the parameters
    within test_torch_train.py's bf16 rule of it, 60 flash and 30
    flash_bwd launches a step on each rank on ``flash_sm90`` /
    ``flash_bwd_sm90``, a checkpoint's moment gather bitwise the
    unsharded moments) and ``train(variant="dponly")`` restarted from a
    checkpoint after a lost device, bitwise the uninterrupted run; step
    ms, each rank's peak and a save's added device bytes, the
    collectives' count and bytes a step;
17. deepseek: holds the flash kernels at two widths (q and k 192
    wide, v 128: MLA's prefill) against their plain version, out and
    lse, bf16 on ``flash_sm90.cu``'s 192/128 instance and fp32 on
    ``flash.cu``, at DeepSeek-V2-Lite's prefill shape (4 x 4,096, 16
    heads) and at ragged shapes (Sq and Sk off the tiles, H > KVH,
    offsets, a window), prints their ptxas lines (a spill of either
    192/128 bf16 kernel, or a wgmma serialised for want of registers
    (C7512) in the Hopper one, fails), and times the kernel, the
    previous design (``flash.cu``'s 192/128 kernel), SDPA at the same
    widths (or its refusal) and the plain version in turns; then runs
    the lm phase's path on DeepSeek-V2-Lite at full width and depth (27
    layers, d 2,048, MLA, 64 routed experts top-6 + 2 shared, the dense
    prologue layer; 31.4 GB of random bf16 weights drawn on the card):
    every flash launch on ``flash_sm90`` (27 a forward; its 192/128
    instance's device time profiled), the MoE aux loss
    finite, decode's agreement with forward printed at the published
    capacity and at one where no group drops a token; then the same
    model in fp32 (62.8 GB) at that capacity: decode's argmax a
    maximiser of forward's logits in more than 0.99 of the prompt
    positions (``DS_FP32_AGREE`` says why);
18. train mla: DeepSeek-V2-Lite trained at full width with its depth
    cut to 3 layers (``MLA_TRAIN_LAYERS``: the dense prologue layer and
    two MLA+MoE layers, random fp32 masters from the seed), 10 AdamW
    steps of 2 x 4,096 tokens, remat on: the loss finite and falling,
    one flash_bwd launch a layer a step, all on ``flash_bwd_sm90``'s
    192/128 instance, the flash forward's on ``flash_sm90``; step ms,
    tokens/s, the peak; one step twice from one state bitwise; a
    profiled step (flash_bwd's device time beside MoE routing's);
19. ssm: Mamba2-130M at full width and depth (24 layers, d 768, 24 SSD
    heads of 64, state 128; random bf16 weights from the seed):
    ``forward`` at 8 x 4,096 (ms, tokens/s, peak, the five leading
    device operations of one profiled forward), ``generate`` over 8
    prompts of 128 + 32 and ``BatchedServer`` (16 requests through 8
    slots), each bitwise a fresh replay; decode held against forward in
    fp32 (argmax agreement above 0.99; bf16's printed); 10 AdamW steps
    of 8 x 4,096 tokens through ``train`` with remat (the loss falls),
    and a run restarted from the step-5 checkpoint after a lost device
    bitwise the uninterrupted one.  The SSD scan is PyTorch on tensors
    (the reference has no Pallas kernel for it): no kernel launches;
20. jamba: the windowed flash (``flash_sm90``, window 4,096) at Jamba's
    shape (1 x 8,192, 32/8 heads of 128) against its plain version,
    timed beside the unwindowed call, SDPA with the window as a mask and
    the plain version; Jamba-v0.1's ``config(long_context=True)`` at
    full width cut to one period of 8 layers (13.26B parameters, 26.5 GB
    of random bf16 weights): ``forward`` at 1 x 8,192 through the
    windowed kernel, ``generate`` and ``BatchedServer`` at 4 x 128 + 16;
    then the ring buffer: the window cut to 128, the model in fp32 at
    capacity_factor E/k, 4 prompts of 160 tokens replayed and 32 decoded
    through a cache of 128 rows (it wraps), decode's argmax a maximiser
    of one forward's logits at the same window in more than 0.99 of the
    positions;
21. whisper: the non-causal flash forward and backward at Whisper's
    encoder shape (8 x 1,500, 16 heads of 64) and cross shape (8 x 448
    queries over 1,500 keys) against their plain versions and SDPA's,
    timed; Whisper-medium at full width and depth (24 + 24 layers,
    random bf16 weights): ``forward`` at 8 x (1,500 frames + 448
    tokens) (72 flash launches a forward, all on ``flash_sm90``),
    ``encode`` -> ``init_serve_cache(enc_out=)`` -> 32 ``serve_step``s;
    in fp32 the card against the CPU at 2 + 2 layers and decode against
    forward at full depth; ``train`` for 10 steps with remat (144 flash
    and 72 flash_bwd launches a step, the loss falls); at full width cut
    to 2 + 2 layers a restart after a lost device, bitwise;
22. internvl2: InternVL2-2B at full width and depth (random bf16
    weights): ``forward`` at 4 x (256 patch embeddings + 3,840 tokens),
    ``generate`` and ``BatchedServer`` text-only; in fp32 the card
    against the CPU at 2 layers with patches; ``train`` at full width cut
    to 8 layers, 10 steps of 2 x (256 + 3,840), flash_bwd's share of a
    profiled step.

Every failed check raises, so the exit code is not 0.  The last two
lines are the ``kernels`` JSON and the device JSON.  Without a CUDA
device, or outside a checkout, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T0 = time.perf_counter()   # the script's start
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
PREVIOUS_SDDMM = "scripts_dev/sddmm_v1.cu"
PREVIOUS_FLASH_BWD = "src/repro_torch/kernels/csrc/flash_bwd.cu"
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
    import sddmm_v1
    import topk_score_v1
    gram_v1.register()         # the previous designs, timed beside
    sddmm_v1.register()
    topk_score_v1.register()
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
          + ", ".join(f"{k} {v:.2f} s"
                      for k, v in sorted(_build.build_seconds.items())))
    # the sources this run built, by content, so that a time in the docs
    # can be tied to the file it was measured on
    for name in sorted(_build._SIGNATURES):
        src = _build._source(name)
        print(f"  sha256 {src.relative_to(ROOT)}: "
              f"{hashlib.sha256(src.read_bytes()).hexdigest()}")
    for name in ("gram", "topk_score", "flash", "flash_sm90"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # the main path launches gram_rows_kernel<float>: its ptxas lines,
    # named, and no spill
    spills = ptxas_by_kernel(_build.build_log("gram"))
    for kernel, lines in spills.items():
        print(f"  ptxas gram {kernel}: " + "; ".join(lines))
    main = [k for k in spills if k == "gram_rows_kernel<float>"]
    if not main or any(" 0 bytes spill stores" not in line
                       for line in spills[main[0]] if "spill" in line):
        raise AssertionError(f"gram's main-path kernel spills or is "
                             f"missing: {spills}")
    # sddmm's kernels; the gathered entries' tiled kernel has one
    # instance a step width and operand kind (fp32, bf16, fp32 u against
    # bf16 rows): none spills, and the main paths' (4 a step: fp32, and
    # the bf16 sweep's bf16 and mixed) are there
    sddmm = ptxas_by_kernel(_build.build_log("sddmm"))
    for kernel, lines in sddmm.items():
        print(f"  ptxas sddmm {kernel}: " + "; ".join(lines))
    tiles = {k: v for k, v in sddmm.items()
             if k.startswith("sddmm_tiles_kernel")}
    want = {f"sddmm_tiles_kernel<float4, {kind}>"
            for kind in ("f32", "bf16", "f32 x bf16")}
    if not want <= set(tiles) or any(
            " 0 bytes spill stores" not in line
            for lines in tiles.values() for line in lines if "spill" in line):
        raise AssertionError(f"sddmm's tiled kernel spills or is missing: "
                             f"{tiles}")
    # the bf16 branches' other instances: gram's rows kernel (the bf16
    # sweep's, K <= 128; its tiled kernels above K = 128 are printed
    # with the others above) and topk_score's scoring kernels in bf16;
    # none of these spills
    bf16 = {"gram gram_rows_kernel<bf16>": spills.get(
        "gram_rows_kernel<bf16>")}
    bf16.update({f"topk_score {k}": v for k, v in ptxas_by_kernel(
        _build.build_log("topk_score")).items() if "bf16" in k})
    for kernel, lines in bf16.items():
        print(f"  ptxas {kernel}: " + "; ".join(lines or []))
    if not bf16["gram gram_rows_kernel<bf16>"] or sum(
            k.startswith("topk_score score_kernel") for k in bf16) != 8 or any(
            " 0 bytes spill stores" not in line
            for lines in bf16.values() for line in lines if "spill" in line):
        raise AssertionError(f"a bf16 instance spills or is missing: "
                             f"{bf16}")
    return smi


def ptxas_by_kernel(log: str):
    """{kernel: its ptxas lines} of a source's build log, kernels named
    from their mangled entry names (gram's, sddmm's and the flash
    backward's as templates, others as mangled)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"(gram_rows_kernel|gram_tiled_kernel)I"
                          r"(13__nv_bfloat16|f)(Lb[01])?", mangled)
            t = re.search(r"sddmm_tiles_kernelILb([01])ELi([012])E",
                          mangled)
            sc = re.search(r"score_kernelILi(\d+)ELb([01])E"
                           r"(f|13__nv_bfloat16)", mangled)
            f = re.search(r"(dkdv_kernel|dq_kernel|stats_kernel|"
                          r"dkdv_bf16_kernel|dq_bf16_kernel|delta_kernel)"
                          r"I(Li(\d+)E(?:Li(\d+)E)?|f|13__nv_bfloat16)",
                          mangled)
            name = mangled if k is None else (
                f"{k.group(1)}<{'bf16' if 'bfloat' in k.group(2) else 'float'}"
                + (f", {k.group(3)[-1] == '1'}" if k.group(3) else "") + ">")
            if t:
                name = (f"sddmm_tiles_kernel<"
                        f"{'float4' if t.group(1) == '1' else 'float'}, "
                        f"{('f32', 'bf16', 'f32 x bf16')[int(t.group(2))]}>")
            if sc:
                name = (f"score_kernel<{sc.group(1)}, "
                        f"{'TMA' if sc.group(2) == '1' else 'plain'}, "
                        f"{'f32' if sc.group(3) == 'f' else 'bf16'}>")
            if f:
                widths = ", ".join(w for w in f.group(3, 4) if w)
                name = f"{f.group(1)}<" + (
                    widths or ("float" if f.group(2) == "f" else "bf16")) \
                    + ">"
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
    del ug, vg
    torch.cuda.empty_cache()
    gathered = gathered_sddmm_main_path(train, U, V, gen.initial_seed())
    del U, V
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
        "sddmm_gathered": gathered,
    }


def gathered_sddmm_main_path(train, U, V, seed: int):
    """sddmm's fused-gather entries at their probes and at the three
    shapes the sweeps give them: the observed entries
    (``gathered_sddmm``, ``_block_pred_observed``) and both sides of
    probit's padded prediction (``gathered_sddmm_padded``: every slot of
    the 131,072 x 64 padded rows, and of the 8,192 padded columns, whose
    compound rows do not fit L2); and at the observed entries in random
    order (``from_coo`` keeps its caller's order and the slice's COO is
    row-major; in random order the kernel has no runs of i to reuse).
    Held against the plain version at SDDMM_TOL and bitwise against
    ``index_select`` x 2 + ``sddmm_f32``
    (the pipeline before the fused entry) and against the first design
    of the fused entry (``scripts_dev/sddmm_v1.cu``); timed beside both,
    the plain version and one library expression (``index_select`` x 2
    + ``torch.linalg.vecdot``).  Returns the kernels-line entry (without
    launches); ``ms`` and the other unprefixed times are the observed
    entries'."""
    import torch
    import sddmm_v1 as previous
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sddmm as ksddmm
    dev = U.device
    err = 0.0

    def check(got, U_, V_, i, j, label):
        """got: the new kernel's output at pred[e] = U_[i[e]] . V_[j[e]]."""
        torch.cuda.synchronize()
        got = got.reshape(-1)
        ug, vg = U_.index_select(0, i), V_.index_select(0, j)
        e = max_err(got, ref.sddmm_ref(ug, vg),
                    ref.sddmm_ref(ug.abs(), vg.abs()), SDDMM_TOL,
                    f"gathered sddmm {label}")
        for what, want in (
                ("index_select x 2 + sddmm_f32", lambda: ksddmm.sddmm_cuda(
                    ug, vg)),
                (PREVIOUS_SDDMM, lambda: previous.gathered(U_, V_, i, j))):
            if not torch.equal(got.view(torch.int32),
                               want().view(torch.int32)):
                raise AssertionError(f"gathered sddmm {label}: not the bits "
                                     f"of {what}")
        print(f"  gathered sddmm {label}: max abs err {e:.3e}; bitwise "
              f"equal to index_select x 2 + sddmm_f32 and to "
              f"{PREVIOUS_SDDMM}")
        return e

    for label, probe in ops.KERNELS["sddmm_gathered"].items():
        U_, V_, i, j = ops.gathered_sddmm_probe(*probe, dev)
        err = max(err, check(ksddmm.sddmm_gathered_cuda(U_, V_, i, j), U_,
                             V_, i, j, label))

    R, T = train.rows.idx.shape
    C, Tc = train.cols.idx.shape
    rows, cols = train.rows.idx, train.cols.idx
    perm = torch.randperm(train.coo_i.shape[0], device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
    si, sj = train.coo_i[perm].contiguous(), train.coo_j[perm].contiguous()
    del perm
    shapes = (
        ("observed entries", U, V, train.coo_i, train.coo_j,
         lambda: ksddmm.sddmm_gathered_cuda(U, V, train.coo_i, train.coo_j)),
        ("observed entries in random order", U, V, si, sj,
         lambda: ksddmm.sddmm_gathered_cuda(U, V, si, sj)),
        (f"probit rows side {R} x {T} slots", U, V,
         ref.slot_rows(R, T, dev), rows.reshape(-1),
         lambda: ksddmm.sddmm_padded_cuda(U, V, rows)),
        (f"probit cols side {C} x {Tc} slots", V, U,
         ref.slot_rows(C, Tc, dev), cols.reshape(-1),
         lambda: ksddmm.sddmm_padded_cuda(V, U, cols)))
    out = {}
    for label, U_, V_, i, j, new in shapes:
        E, K = i.shape[0], U_.shape[1]
        label = f"{label} E={E} K={K}"
        padded = "slots" in label
        got = new()
        err = max(err, check(got, U_, V_, i, j, label))
        if padded and not torch.equal(
                got.reshape(-1).view(torch.int32),
                ksddmm.sddmm_gathered_cuda(U_, V_, i, j).view(torch.int32)):
            raise AssertionError(f"gathered sddmm {label}: the padded entry "
                                 "is not the bits of the gathered entry")
        del got
        ms = time_ms(new)
        v1 = time_ms(lambda: previous.gathered(U_, V_, i, j))
        pipe = time_ms(lambda: ksddmm.sddmm_cuda(U_.index_select(0, i),
                                                 V_.index_select(0, j)))
        plain = time_ms(lambda: ref.gathered_sddmm_ref(U_, V_, i, j))
        lib = time_ms(lambda: torch.linalg.vecdot(U_.index_select(0, i),
                                                  V_.index_select(0, j)))
        # the function's bytes: each row of both factors, the indices (i
        # and j; a padded layout's idx alone) and the output once
        n_idx = 1 if padded else 2
        n_bytes = 4 * (U_.numel() + V_.numel() + (n_idx + 1) * E)
        b_ms, b_by = bound(n_bytes, 2 * E * K)
        # the design's model of what it reads (no counter measures it):
        # V's row an entry, U's row a run of i (and at most once more a
        # warp, where a run crosses into the next warp's range), the
        # indices and the output
        runs = int(torch.unique_consecutive(i).numel())
        per_entry = 4 * K + 4 * K * runs / E + 4 * (n_idx + 1)
        print(f"  gathered sddmm {label}: {ms:.3f} ms; {PREVIOUS_SDDMM} "
              f"{v1:.3f} ms; pipeline (index_select x 2 + sddmm_f32) "
              f"{pipe:.3f} ms; plain {plain:.3f} ms; library (index_select "
              f"x 2 + torch.linalg.vecdot) {lib:.3f} ms; bound {b_ms:.3f} ms "
              f"by {b_by} (U, V, indices, out once: {n_bytes / 1e6:.1f} MB; "
              f"{b_ms / ms:.3f} of it); modelled reads {per_entry:.1f} B an "
              f"entry ({runs} runs of i), {per_entry * E / 1e9:.3f} GB; "
              f"modelled bytes / measured ms {per_entry * E / ms / 1e6:.0f} "
              f"GB/s through the caches")
        out[label] = dict(ms=ms, previous_ms=v1, pipeline_ms=pipe,
                          plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                          bound_by=b_by)
    del shapes, si, sj
    main, shuffled, prow, pcol = out.values()
    # the observed entries are distinct cells: one library call computes
    # the same function, cuSPARSE's SDDMM over their CSR pattern (the
    # probit slots repeat a cell at their padding, which CSR does not
    # hold)
    nnz = int(train.nnz)
    i64, j64 = train.coo_i[:nnz].long(), train.coo_j[:nnz].long()
    order = torch.argsort(i64 * V.shape[0] + j64)
    crow = torch.zeros(U.shape[0] + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(i64, minlength=U.shape[0]), 0)
    pattern = torch.sparse_csr_tensor(
        crow, j64[order], torch.zeros(nnz, device=dev),
        size=(U.shape[0], V.shape[0]), check_invariants=True)
    Vt = V.T.contiguous()
    lib_sddmm = torch.sparse.sampled_addmm(pattern, U, Vt, beta=0.0)
    got = ksddmm.sddmm_gathered_cuda(U, V, train.coo_i[:nnz],
                                     train.coo_j[:nnz])[order]
    max_err(lib_sddmm.values(), got,
            ref.gathered_sddmm_ref(U.abs(), V.abs(), train.coo_i[:nnz],
                                   train.coo_j[:nnz])[order], SDDMM_TOL,
            "torch.sparse.sampled_addmm against the gathered sddmm")
    sampled = time_ms(lambda: torch.sparse.sampled_addmm(pattern, U, Vt,
                                                         beta=0.0))
    print(f"  observed entries: torch.sparse.sampled_addmm (cuSPARSE SDDMM "
          f"over the CSR pattern) {sampled:.3f} ms, within SDDMM_TOL of "
          f"the gathered sddmm ({main['ms']:.3f} ms)")
    del pattern, lib_sddmm, got, order
    return {"name": "sddmm_gathered", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sddmm.cu",
            "replaces": "src/repro/kernels/sddmm.py:53",
            "max_abs_err": err, **main, "library_ms": sampled,
            "library_expression_ms": main["library_ms"],
            "previous_source": PREVIOUS_SDDMM,
            **{f"{side}_{key}": d[key]
               for side, d in (("random_order", shuffled),
                               ("probit_rows", prow), ("probit_cols", pcol))
               for key in ("ms", "previous_ms", "pipeline_ms", "bound_ms",
                           "library_ms")}}


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


# bf16_gather: the bf16 branches of gram's gathered entry, sddmm and
# topk_score against their plain versions.  Every product of two bf16
# values is exact in fp32, so the kernels differ from the plain versions
# only by the order of fp32 sums, as in fp32: the same tolerances
BF16_REASON = ("bf16 operands widened exactly on both sides, products "
               "exact in fp32, fp32 sums in another order: GRAM_TOL and "
               "SDDMM_TOL of the sum of the terms' magnitudes")
BF16_LIBRARY = {
    "gram_gathered_bf16": "none: no PyTorch call rounds val * mask to bf16 "
                          "and takes the Gram of bf16 rows in fp32 (torch.bmm "
                          "on bf16 returns bf16)",
    "sddmm_bf16": "none: torch.linalg.vecdot and einsum on bf16 return bf16 "
                  "(the kernel's sums are fp32)",
    "sddmm_gathered_bf16": "none: as sddmm_bf16, and "
                           "torch.sparse.sampled_addmm returns bf16 values "
                           "on bf16 factors",
    "topk_score_bf16": "none: einsum over bf16 stacks returns bf16 scores"}


def bf16_pipeline_gram(fixed, idx, val, mask, alpha, lam, acc=None):
    """The pipeline the bf16 gathered entry replaces: ``index_select`` of
    the bf16 rows, ``gram_bf16`` on the slab, then ``mul_`` by alpha,
    ``add_`` into acc and ``add_`` of Lambda_p, each rounded apart."""
    from repro_torch.kernels import gram as kgram
    R, T = idx.shape
    vg = fixed.index_select(0, idx.reshape(-1)).reshape(R, T, -1)
    g, r = kgram.gram_cuda(vg, val, mask)
    del vg
    g.mul_(alpha)
    r.mul_(alpha)
    if acc is not None:
        g = acc[0].add_(g)
        r = acc[1].add_(r)
    return g.add_(lam), r


def bf16_kernels_main_path(train, gen):
    """The bf16 entries of the bf16_gather sweep (``gram_gathered_bf16``,
    ``sddmm_bf16``, ``sddmm_gathered_bf16`` and the padded entries:
    ``sddmm_padded_mixed`` for probit, ``sddmm_padded_bf16`` for the
    distributed residuals) at the reference's probes in bf16 and at the
    sweep's shapes: held against their plain versions (GRAM_TOL,
    SDDMM_TOL), each fused entry bitwise the pipeline it replaces
    (``index_select`` + the pre-gathered bf16 entry, for sddmm as the
    ROADMAP's Watch asks) and the padded entries bitwise the fp32 entry
    on the widened rows; timed beside the plain version, the pipeline
    and the fp32 entry at the same shape.  Returns the kernels-line
    entries (without launches)."""
    import torch
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sddmm as ksddmm
    dev, K = train.device, 128
    bf = torch.bfloat16
    print(f"bf16 tolerance: {BF16_REASON}")

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    errs = dict.fromkeys(("gram", "sddmm", "gathered", "mixed"), 0.0)
    for label, (E, k) in ops.KERNELS["sddmm_bf16"].items():
        u, v = rand(E, k).to(bf), rand(E, k).to(bf)
        p = ksddmm.sddmm_cuda(u, v)
        e = max_err(p, ref.sddmm_ref(u, v), ref.sddmm_ref(u.abs(), v.abs()),
                    SDDMM_TOL, f"sddmm bf16 {label}")
        errs["sddmm"] = max(errs["sddmm"], e)
        print(f"  sddmm_bf16 {label}: max abs err {e:.3e}")
    for label, probe in ops.KERNELS["sddmm_gathered"].items():
        U_, V_, i, j = ops.gathered_sddmm_probe(*probe, dev)
        U_, V_ = U_.to(bf), V_.to(bf)
        p = ksddmm.sddmm_gathered_cuda(U_, V_, i, j)
        e = max_err(p, ref.gathered_sddmm_ref(U_, V_, i, j),
                    ref.gathered_sddmm_ref(U_.abs(), V_.abs(), i, j),
                    SDDMM_TOL, f"gathered sddmm bf16 {label}")
        if not bits(p, ksddmm.sddmm_cuda(U_.index_select(0, i),
                                         V_.index_select(0, j))):
            raise AssertionError(f"gathered sddmm bf16 {label}: not the bits "
                                 "of index_select x 2 + sddmm_bf16")
        errs["gathered"] = max(errs["gathered"], e)
        print(f"  sddmm_gathered_bf16 {label}: max abs err {e:.3e}; bitwise "
              "index_select x 2 + sddmm_bf16")

    # gram's gathered bf16 entry at the reference's bf16 probe shape
    (R, T, k), _ = ops.KERNELS["gram"]["bf16 gathered operands"]
    fixed16 = rand(4 * R, k).to(bf)
    idx = torch.randint(0, 4 * R, (R, T), device=dev, generator=gen,
                        dtype=torch.int32)
    val, alpha = rand(R, T), torch.tensor(0.7, device=dev)
    mask = (torch.rand(R, T, device=dev, generator=gen) > 0.2).float()
    lam = rand(k, k)
    got = kgram.gathered_gram_cuda(fixed16, idx, val, mask, alpha, lam=lam)
    want = ref.gathered_gram_ref(fixed16, idx, val, mask, alpha, lam=lam)
    scale = ref.gathered_gram_ref(fixed16.abs(), idx, val.abs(), mask, alpha,
                                  lam=lam.abs())
    e = max(max_err(got[0], want[0], scale[0], GRAM_TOL, "gram bf16 probe"),
            max_err(got[1], want[1], scale[1], GRAM_TOL, "rhs bf16 probe"))
    if not all(bits(a, b) for a, b in zip(got, bf16_pipeline_gram(
            fixed16, idx, val, mask, alpha, lam))):
        raise AssertionError("gram_gathered_bf16 at the bf16 probe: not the "
                             "bits of index_select + gram_bf16 + mul_ + add_")
    errs["gram"] = e
    print(f"  gram_gathered_bf16 bf16 gathered operands r{R} t{T} K{k}: max "
          f"abs err {e:.3e}; bitwise index_select + gram_bf16 + mul_ + add_")

    U, V = rand(train.n_rows, K), rand(train.n_cols, K)
    U16, V16 = U.to(bf), V.to(bf)
    out = {}

    # gram's gathered entry at both half-sweeps, alpha and a Lambda_p
    # that is not symmetric, once with acc
    alpha = torch.tensor(1.0 / NOISE ** 2, device=dev)
    W = rand(K, K)
    lam = W @ W.mT / K + 1e-3 * rand(K, K)
    t = dict.fromkeys(("ms", "plain_ms", "pipeline_ms", "f32_ms",
                       "bound_ms"), 0.0)
    by = {"bytes": 0.0, "operations": 0.0}
    for name, padded, fixed, fixed16 in (("rows", train.rows, V, V16),
                                         ("cols", train.cols, U, U16)):
        idx, val, mask = padded.idx, padded.val, padded.mask
        R, T = idx.shape
        label = f"{name} R={R} T={T} K={K}"
        for with_acc in (False, True):
            acc = (rand(R, K, K), rand(R, K)) if with_acc else None
            copy = (lambda: None) if acc is None else \
                (lambda: tuple(a.clone() for a in acc))
            got = kgram.gathered_gram_cuda(fixed16, idx, val, mask, alpha,
                                           lam=lam, acc=copy())
            torch.cuda.synchronize()
            want = ref.gathered_gram_ref(fixed16, idx, val, mask, alpha,
                                         lam=lam, acc=copy())
            scale = ref.gathered_gram_ref(
                fixed16.abs(), idx, val.abs(), mask, alpha, lam=lam.abs(),
                acc=None if acc is None else tuple(a.abs() for a in acc))
            e = max(max_err(got[0], want[0], scale[0], GRAM_TOL,
                            f"gathered gram bf16 {label}"),
                    max_err(got[1], want[1], scale[1], GRAM_TOL,
                            f"gathered rhs bf16 {label}"))
            del want, scale
            pipe = bf16_pipeline_gram(fixed16, idx, val, mask, alpha, lam,
                                      acc=copy())
            if not all(bits(a, b) for a, b in zip(got, pipe)):
                raise AssertionError(f"gathered gram bf16 {label}: not the "
                                     "bits of index_select + gram_bf16 + "
                                     "mul_ + add_")
            errs["gram"] = max(errs["gram"], e)
            print(f"  gram_gathered_bf16 {label}"
                  f"{', acc' if with_acc else ''}: max abs err {e:.3e}; "
                  "bitwise index_select + gram_bf16 + mul_ + add_")
            del got, pipe, acc
            torch.cuda.empty_cache()
        nnz = float(mask.sum())
        n_bytes = 2 * fixed16.numel() + 4 * (3 * R * T + R * K * K + R * K)
        n_ops = nnz * K * (K + 1) + 2 * nnz * K
        # bf16 x bf16 products summed in fp32: the tensor cores' bf16 rate
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
        ms = time_ms(lambda: kgram.gathered_gram_cuda(fixed16, idx, val,
                                                      mask, alpha, lam=lam))
        f32 = time_ms(lambda: kgram.gathered_gram_cuda(fixed, idx, val, mask,
                                                       alpha, lam=lam))
        pipe = time_ms(lambda: bf16_pipeline_gram(fixed16, idx, val, mask,
                                                  alpha, lam), n=5)
        plain = time_ms(lambda: ref.gathered_gram_ref(
            fixed16, idx, val, mask, alpha, lam=lam), n=5)
        torch.cuda.empty_cache()
        print(f"  gram_gathered_bf16 {label}: {ms:.3f} ms (fp32 entry "
              f"{f32:.3f} ms), bound {b_ms:.3f} ms by {b_by} "
              f"({n_bytes / 1e9:.3f} GB, {n_ops / 1e9:.1f} GFLOP; "
              f"{b_ms / ms:.3f} of it); pipeline {pipe:.3f} ms; plain "
              f"{plain:.3f} ms")
        for key, val_ in (("ms", ms), ("plain_ms", plain),
                          ("pipeline_ms", pipe), ("f32_ms", f32),
                          ("bound_ms", b_ms)):
            t[key] += val_
        by[b_by] += b_ms
    print(f"  gram_gathered_bf16, both half-sweeps: {t['ms']:.3f} ms (fp32 "
          f"entry {t['f32_ms']:.3f}), bound {t['bound_ms']:.3f} ms")
    out["gram_gathered_bf16"] = {
        "name": "gram_gathered_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram.py:83", "max_abs_err":
        errs["gram"], **t, "bound_by": max(by, key=by.get),
        "library_ms": None, "library_note": BF16_LIBRARY["gram_gathered_bf16"]}

    # sddmm: the pre-gathered entry and the observed entries
    i, j = train.coo_i, train.coo_j
    E = i.shape[0]
    ug, vg = U16.index_select(0, i), V16.index_select(0, j)
    p = ksddmm.sddmm_cuda(ug, vg)
    e = max_err(p, ref.sddmm_ref(ug, vg), ref.sddmm_ref(ug.abs(), vg.abs()),
                SDDMM_TOL, f"sddmm bf16 main path E={E}")
    errs["sddmm"] = max(errs["sddmm"], e)
    ms = time_ms(lambda: ksddmm.sddmm_cuda(ug, vg))
    f32 = time_ms(lambda: ksddmm.sddmm_cuda(ug.float(), vg.float()))
    plain = time_ms(lambda: ref.sddmm_ref(ug, vg))
    b_ms, b_by = bound(2 * 2 * E * K + 4 * E, 2 * E * K, PEAK_BF16_FLOPS)
    print(f"  sddmm_bf16 E={E} K={K}: {ms:.3f} ms, max abs err {e:.3e}; "
          f"plain {plain:.3f} ms; fp32 entry on widened copies (with the "
          f"copies) {f32:.3f} ms; bound {b_ms:.3f} ms by {b_by}")
    out["sddmm_bf16"] = {
        "name": "sddmm_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sddmm.cu",
        "replaces": "src/repro/kernels/sddmm.py:53", "max_abs_err":
        errs["sddmm"], "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "library_note": BF16_LIBRARY["sddmm_bf16"]}
    got = ksddmm.sddmm_gathered_cuda(U16, V16, i, j)
    e = max_err(got, ref.sddmm_ref(ug, vg), ref.sddmm_ref(ug.abs(),
                                                          vg.abs()),
                SDDMM_TOL, f"gathered sddmm bf16 observed entries E={E}")
    if not bits(got, p):
        raise AssertionError("gathered sddmm bf16, observed entries: not the "
                             "bits of index_select x 2 + sddmm_bf16")
    errs["gathered"] = max(errs["gathered"], e)
    del ug, vg, p, got
    ms = time_ms(lambda: ksddmm.sddmm_gathered_cuda(U16, V16, i, j))
    f32 = time_ms(lambda: ksddmm.sddmm_gathered_cuda(U, V, i, j))
    pipe = time_ms(lambda: ksddmm.sddmm_cuda(U16.index_select(0, i),
                                             V16.index_select(0, j)))
    plain = time_ms(lambda: ref.gathered_sddmm_ref(U16, V16, i, j))
    b_ms, b_by = bound(2 * (U16.numel() + V16.numel()) + 4 * 3 * E,
                       2 * E * K, PEAK_BF16_FLOPS)
    print(f"  sddmm_gathered_bf16 observed entries E={E} K={K}: {ms:.3f} ms "
          f"(fp32 entry {f32:.3f} ms), max abs err {e:.3e}, bitwise "
          f"index_select x 2 + sddmm_bf16; pipeline {pipe:.3f} ms; plain "
          f"{plain:.3f} ms; bound {b_ms:.3f} ms by {b_by}")
    out["sddmm_gathered_bf16"] = {
        "name": "sddmm_gathered_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sddmm.cu",
        "replaces": "src/repro/kernels/sddmm.py:53",
        "max_abs_err": errs["gathered"], "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "pipeline_ms": pipe,
        "f32_ms": f32, "library_ms": None,
        "library_note": BF16_LIBRARY["sddmm_gathered_bf16"]}

    # the padded entries: probit's fp32 u against bf16 rows, both sides,
    # and the distributed residuals' bf16 x bf16
    mixed = dict.fromkeys(("ms", "plain_ms", "f32_ms", "bound_ms"), 0.0)
    mby = {"bytes": 0.0, "operations": 0.0}
    for name, u, fixed16, idx in (("rows", U, V16, train.rows.idx),
                                  ("cols", V, U16, train.cols.idx)):
        R, T = idx.shape
        label = f"probit {name} side {R} x {T} slots K={K}"
        got = ksddmm.sddmm_padded_cuda(u, fixed16, idx)
        wide = fixed16.float()
        if not bits(got, ksddmm.sddmm_padded_cuda(u, wide, idx)):
            raise AssertionError(f"sddmm_padded_mixed {label}: not the bits "
                                 "of the fp32 entry on the widened rows")
        want = ref.gathered_sddmm_padded_ref(u, fixed16, idx)
        e = max_err(got, want, ref.gathered_sddmm_padded_ref(
            u.abs(), fixed16.abs(), idx), SDDMM_TOL, f"mixed {label}")
        errs["mixed"] = max(errs["mixed"], e)
        del got, want
        ms = time_ms(lambda: ksddmm.sddmm_padded_cuda(u, fixed16, idx))
        f32 = time_ms(lambda: ksddmm.sddmm_padded_cuda(u, wide, idx))
        plain = time_ms(lambda: ref.gathered_sddmm_padded_ref(u, fixed16,
                                                              idx))
        del wide
        b_ms, b_by = bound(4 * u.numel() + 2 * fixed16.numel()
                           + 4 * 2 * R * T, 2 * R * T * K)
        print(f"  sddmm_padded_mixed {label}: {ms:.3f} ms (fp32 entry "
              f"{f32:.3f} ms), max abs err {e:.3e}, bitwise the fp32 entry "
              f"on the widened rows; plain {plain:.3f} ms; bound "
              f"{b_ms:.3f} ms by {b_by}")
        for key, val_ in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32),
                          ("bound_ms", b_ms)):
            mixed[key] += val_
        mby[b_by] += b_ms
        u16 = u.to(bf)
        got = ksddmm.sddmm_padded_cuda(u16, fixed16, idx)
        if not bits(got, ksddmm.sddmm_padded_cuda(u16.float(),
                                                  fixed16.float(), idx)):
            raise AssertionError(f"sddmm_padded_bf16 {name}: not the bits of "
                                 "the fp32 entry on the widened operands")
        print(f"  sddmm_padded_bf16 {name} side (the distributed "
              "residuals): bitwise the fp32 entry on the widened operands")
        del got, u16
    torch.cuda.empty_cache()
    out["sddmm_padded_mixed"] = {
        "name": "sddmm_padded_mixed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sddmm.cu",
        "replaces": "src/repro/kernels/sddmm.py:53",
        "max_abs_err": errs["mixed"], **mixed,
        "bound_by": max(mby, key=mby.get), "library_ms": None,
        "library_note": BF16_LIBRARY["sddmm_gathered_bf16"]}
    del U, V, U16, V16
    torch.cuda.empty_cache()
    return out


def golden_views(seed: int):
    """The golden ``gfa`` chain's two dense views (48 x 16 and 48 x 12),
    a planted K = 4 product plus 0.1 noise, from numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(48, 4)).astype(np.float32)
    views = []
    for D in (16, 12):
        W = rng.normal(size=(D, 4)).astype(np.float32)
        views.append((Z @ W.T + 0.1 * rng.normal(size=(48, D)))
                     .astype(np.float32))
    return views


def golden_model(name: str, seed: int, device):
    """(model, data) of ``results/golden_chains.json``'s chain ``name``,
    built as ``tests/test_golden_chain.py`` builds it: K = 4; 48 x 32
    sparse with adaptive (``gaussian``) or probit (``probit``) noise, or
    FixedNormal samples against two fully observed dense views with
    spike-and-slab loadings (``gfa``)."""
    from repro_torch import core as tc
    K = 4
    if name == "gfa":
        ents = [tc.EntityDef("samples", 48, tc.FixedNormalPrior(K))]
        blocks, payloads = [], []
        for m, X in enumerate(golden_views(seed)):
            D = X.shape[1]
            ents.append(tc.EntityDef(f"view{m}", D, tc.SpikeAndSlabPrior(K)))
            blocks.append(tc.BlockDef(0, m + 1, tc.AdaptiveGaussian(),
                                      sparse=False))
            payloads.append(tc.dense_block(X, device=device))
        model = tc.ModelDef(tuple(ents), tuple(blocks), K, device=device)
        return model, tc.MFData(tuple(payloads), (None,) * len(ents))
    binary = name == "probit"
    mat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3, binary=binary,
                                 device=device)
    noise = tc.ProbitNoise() if binary else tc.AdaptiveGaussian()
    model = tc.ModelDef((tc.EntityDef("r", 48, tc.NormalPrior(K)),
                         tc.EntityDef("c", 32, tc.NormalPrior(K))),
                        (tc.BlockDef(0, 1, noise, sparse=True),), K,
                        device=device)
    return model, tc.MFData((mat,), (None, None))


def golden_wrapper_chain(name: str, seed: int, sweeps: int):
    """The golden chain ``name`` through the session wrappers, as the
    reference's ``test_wrappers_replay_golden_chain`` runs it:
    ``TrainSession`` for ``gaussian``/``probit``,
    ``GFASession(zero_init_loadings=False)`` for ``gfa``."""
    from repro_torch import core as tc
    got = {"rmse_train": [], "alpha": []}

    def trace(info):
        got["rmse_train"].append(float(info.metrics["rmse_train_0"]))
        got["alpha"].append(float(info.metrics["alpha_0"]))

    if name == "gfa":
        tc.GFASession(golden_views(seed), num_latent=4, burnin=sweeps,
                      nsamples=0, seed=seed, zero_init_loadings=False,
                      callbacks=[trace]).run()
        return got
    binary = name == "probit"
    mat, _, _ = tc.random_sparse(seed, (48, 32), 0.3, rank=3, binary=binary,
                                 device="cuda")
    s = tc.TrainSession(num_latent=4, burnin=sweeps, nsamples=0, seed=seed,
                        callbacks=[trace])
    s.add_train_and_test(mat, noise=tc.ProbitNoise() if binary
                         else tc.AdaptiveGaussian())
    s.run()
    return got


def phase_golden():
    """The golden ``gaussian``, ``probit`` and ``gfa`` chains (seed 11,
    3 sweeps) on the card, at the fixture tolerance; then each through
    its session wrapper, bitwise the engine's chain."""
    import numpy as np
    from repro_torch.core import gibbs_step, init_state
    golden = json.loads(GOLDEN.read_text())
    seed, sweeps = golden["seed"], golden["sweeps"]
    for name in ("gaussian", "probit", "gfa"):
        model, data = golden_model(name, seed, "cuda")
        state = init_state(model, data, seed=seed)
        got = {"rmse_train": [], "alpha": []}
        for _ in range(sweeps):
            state, m = gibbs_step(model, data, state)
            got["rmse_train"].append(float(m["rmse_train_0"]))
            got["alpha"].append(float(m["alpha_0"]))
        wrapped = golden_wrapper_chain(name, seed, sweeps)
        if wrapped != got:
            raise AssertionError(f"golden {name}: the wrapper's chain "
                                 f"{wrapped} is not the engine's {got}")
        want = golden["chains"][name]
        for key in ("rmse_train", "alpha"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                       atol=1e-5,
                                       err_msg=f"golden {name} {key}")
        rel = max(abs(g - w) / abs(w) for key in ("rmse_train", "alpha")
                  for g, w in zip(got[key], want[key]))
        print(f"golden {name} chain on cuda: rmse_train "
              f"{got['rmse_train']}, alpha {got['alpha']} (fixture {want});"
              f" largest relative difference {rel:.2e}; rtol 1e-3 atol "
              f"1e-5; the {'GFASession' if name == 'gfa' else 'TrainSession'}"
              " replay bitwise the same")


def run_timed(sess):
    """``sess.run()`` with the card synchronized after every sweep:
    (result, ms of each sweep, peak device bytes).  The first sweep's
    time includes ``init_state``."""
    import torch
    stamps = []

    def stamp(info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    sess.callbacks = tuple(sess.callbacks) + (stamp,)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sess.run()
    peak = torch.cuda.max_memory_allocated()
    edges = [t0] + stamps
    return res, [(b - a) * 1e3 for a, b in zip(edges, edges[1:])], peak


def sweep_summary(label, ms, peak, extra=""):
    med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    print(f"{label}: sweeps " + ", ".join(f"{m:.1f}" for m in ms)
          + f" ms (the first with init_state); median after the first "
          f"{med:.1f} ms; peak device memory {peak / 1e9:.2f} GB{extra}")
    return med


def check_launches(label, counts, want):
    from repro_torch.kernels import ops
    full = dict.fromkeys(ops.launch_counts(), 0)
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label}: launch counts {counts}, want {full}")


def check_finite(label, res):
    import math
    import torch
    if not all(math.isfinite(v) for v in res.rmse_train_trace):
        raise AssertionError(f"{label}: non-finite rmse_train "
                             f"{res.rmse_train_trace}")
    for f in res.state.factors:
        if not torch.isfinite(f).all():
            raise AssertionError(f"{label}: non-finite factor")


def phase_slice(train, test, burnin: int, nsamples: int, seed: int):
    """The main path through the entry points a user calls."""
    import math
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    from repro_torch.kernels import ops

    b = ModelBuilder(num_latent=128)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, test=test,
                noise=AdaptiveGaussian())
    sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed)
    ops.reset_launch_counts()
    res, sweep_ms, peak = run_timed(sess)
    counts = ops.launch_counts()
    sweeps = burnin + nsamples
    for s in range(sweeps):
        print(f"  sweep {s} ({'burnin' if s < burnin else 'sample'}): "
              f"{sweep_ms[s]:.1f} ms, rmse_train "
              f"{res.rmse_train_trace[s]:.6f}")
    print(f"slice: rmse_test {res.rmse_test:.6f}, runtime_s "
          f"{res.runtime_s:.3f}, peak device memory "
          f"{peak / 1e9:.2f} GB, launches {counts}")
    check_finite("slice", res)
    if not math.isfinite(res.rmse_test):
        raise AssertionError(f"slice: rmse_test {res.rmse_test}")
    # the chain must learn: some later sweep fits the training entries
    # better than the first (in burn-in the trace need not be monotone)
    first, later = res.rmse_train_trace[0], res.rmse_train_trace[1:]
    if not min(later) < first:
        raise AssertionError(
            f"slice: rmse_train never fell below the first sweep's: "
            f"{res.rmse_train_trace}")
    # gram: one launch per half-sweep; the gathered sddmm one per sweep
    # for the training residual; sddmm one per posterior sample for the
    # test set
    check_launches("slice", counts, {"gram": 2 * sweeps, "sddmm": nsamples,
                                     "sddmm_gathered": sweeps})
    return sess, res, counts, sweep_ms


def phase_witness(train, test, seed: int, bf16_gather: bool = False):
    """The slice's data at K = 16, the planted rank, run to convergence:
    on the card, the test-set predictions (``PredictAccumulator`` and the
    test-set sddmm) must come near the planted noise.  At K = 128 with
    64 observations per compound six sweeps cannot show that.  Returns
    the test RMSE."""
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    b = ModelBuilder(num_latent=16, bf16_gather=bf16_gather)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, test=test,
                noise=AdaptiveGaussian())
    res = b.session(burnin=WITNESS_SWEEPS[0], nsamples=WITNESS_SWEEPS[1],
                    seed=seed).run()
    zero = float(torch.as_tensor(test[2]).square().mean().sqrt())
    print(f"witness K=16{', bf16_gather' if bf16_gather else ''}, "
          f"{sum(WITNESS_SWEEPS)} sweeps: rmse_train "
          f"{res.rmse_train_trace[0]:.4f} -> {res.rmse_train_trace[-1]:.4f}"
          f", rmse_test {res.rmse_test:.4f} (planted noise {NOISE}, "
          f"predicting 0 gives {zero:.4f}), runtime_s {res.runtime_s:.3f}")
    if not res.rmse_test < 2 * NOISE:
        raise AssertionError(f"witness: rmse_test {res.rmse_test} is not "
                             f"below twice the planted noise {NOISE}")
    return res.rmse_test


BF16_SWEEPS = (2, 4)       # burn-in, posterior samples of the bf16 slice
BF16_PROBIT = 16384        # compounds of the bf16 probit run
BF16_PROBIT_SWEEPS = (2, 1)


def phase_bf16(train, test, seed: int, gen, fp32):
    """``ModelBuilder(bf16_gather=True)`` (the reference's production
    variant, ``mf_dryrun --variant bf16gather``) at the slice's full
    width: the bf16 entries against their plain versions
    (``bf16_kernels_main_path``); 2 + 4 sweeps of the slice, the median
    sweep and the peak beside the fp32 slice's (``fp32``: its median ms,
    peak bytes and test RMSE), the train RMSE trace, the launches by
    entry (the bf16 entries on the path, the fp32 gathered entries not
    at all); one profiled sweep; the K = 16 witness in bf16 beside
    fp32's; probit at 16,384 compounds through the mixed padded entry.
    Returns (kernels-line entries, the launches of the slice's run and
    of the probit run)."""
    import math
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder, ProbitNoise
    from repro_torch.kernels import ops
    entries = bf16_kernels_main_path(train, gen)
    torch.cuda.empty_cache()

    burnin, nsamples = BF16_SWEEPS
    sweeps = burnin + nsamples
    b = ModelBuilder(num_latent=128, bf16_gather=True)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, test=test,
                noise=AdaptiveGaussian())
    sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed)
    ops.reset_launch_counts()
    res, ms, peak = run_timed(sess)
    counts = ops.launch_counts()
    check_finite("bf16 slice", res)
    if not math.isfinite(res.rmse_test):
        raise AssertionError(f"bf16 slice: rmse_test {res.rmse_test}")
    first, later = res.rmse_train_trace[0], res.rmse_train_trace[1:]
    if not min(later) < first:
        raise AssertionError(f"bf16 slice: rmse_train never fell below the "
                             f"first sweep's: {res.rmse_train_trace}")
    # the bf16 entries carry the path: gram's a half-sweep, the gathered
    # sddmm's a sweep (the residuals); the test set's sddmm is fp32 (the
    # posterior samples are the fp32 factors), one a sample; the fp32
    # gathered entries are not launched
    check_launches("bf16 slice", counts,
                   {"gram_gathered_bf16": 2 * sweeps,
                    "sddmm_gathered_bf16": sweeps, "sddmm": nsamples})
    trace = [round(v, 6) for v in res.rmse_train_trace]
    med = sweep_summary(
        "bf16 slice", ms, peak,
        f"; fp32 slice median {fp32['ms']:.1f} ms, peak "
        f"{fp32['peak'] / 1e9:.2f} GB; rmse_train {trace}; rmse_test "
        f"{res.rmse_test:.6f} (fp32 slice {fp32['rmse_test']:.6f}); launches "
        f"{counts}")
    profile_sweep(sess.model, sess.data, res.state, med, "bf16 slice "
                  "profile", top=8)
    del sess, res
    torch.cuda.empty_cache()

    rmse16 = phase_witness(train, test, seed, bf16_gather=True)
    print(f"witness: test RMSE bf16_gather {rmse16:.4f}, fp32 "
          f"{fp32['witness']:.4f}")
    if not abs(rmse16 - fp32["witness"]) < 0.1 * fp32["witness"]:
        raise AssertionError(f"witness: bf16 test RMSE {rmse16} is not "
                             f"within 10% of fp32's {fp32['witness']}")

    small, stest = slice_data(BF16_PROBIT, seed, "cuda")
    mat = with_values(small, (small.coo_v > 0).float())
    test_b = (stest[0], stest[1], (stest[2] > 0).astype("float32"))
    burnin, nsamples = BF16_PROBIT_SWEEPS
    sweeps = burnin + nsamples
    b = ModelBuilder(num_latent=128, bf16_gather=True)
    b.add_entity("compound", small.n_rows)
    b.add_entity("protein", small.n_cols)
    b.add_block("compound", "protein", mat, test=test_b, noise=ProbitNoise())
    sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed)
    ops.reset_launch_counts()
    res, ms, peak = run_timed(sess)
    pcounts = ops.launch_counts()
    check_finite("bf16 probit", res)
    # the latents around the mixed entry's predictions, one a half-sweep
    check_launches("bf16 probit", pcounts,
                   {"gram_gathered_bf16": 2 * sweeps,
                    "sddmm_padded_mixed": 2 * sweeps,
                    "sddmm_gathered_bf16": sweeps, "sddmm": nsamples})
    sweep_summary(f"bf16 probit ({BF16_PROBIT} compounds)", ms, peak,
                  f"; rmse_train {[round(v, 6) for v in res.rmse_train_trace]}"
                  f"; test AUC {res.auc_test:.4f}; launches {pcounts}")
    del sess, res, mat, small
    torch.cuda.empty_cache()
    return entries, {"slice": counts, "probit": pcounts}


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
    # a profile of this one short step has come back without its device
    # events once in many runs: a second step is profiled then, and said
    for attempt in range(2):
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
        if busy > 0:
            break
        print(f"  one step, {path['label']}: the profile holds no device "
              f"event (try {attempt + 1}); profiling another step")
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


def topk_bf16(shapes, check, launches: int):
    """``topk_score_bf16`` at both serving shapes, on bf16 copies of the
    stored stacks and user rows: held against the plain version's bf16
    branch (``check``), bitwise the fp32 kernel on the widened copies
    (the same float program) and a batched call bitwise B single-user
    calls; timed beside the plain version and the fp32 kernel.
    ``launches`` is its count in the serving path's run: no path of the
    reference reaches this branch (its serving scores fp32 stores).
    Returns the kernels-line entry."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk_score as ktopk
    entry = {"name": "topk_score_bf16", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk_score.cu",
             "replaces": "src/repro/kernels/topk_score.py:139",
             "launches": launches, "launches_note": "the serving path's "
             "count; no path of the reference reaches the bf16 branch; "
             "held and timed here",
             "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "f32_ms": 0.0,
             "library_ms": None, "library_note": BF16_LIBRARY[
                 "topk_score_bf16"]}
    by = {"bytes": 0.0, "operations": 0.0}
    errs = []
    for label, us, v, excl in shapes:
        S, N, K = v.shape
        label = f"{label} bf16 B={SERVE_SLOTS} S={S} N={N} K={K}"
        us16, v16 = us.to(torch.bfloat16), v.to(torch.bfloat16)
        before = ktopk.launches["topk_score_bf16"]
        got = check(us16, v16, SERVE_K, excl, label)
        if ktopk.launches["topk_score_bf16"] != before + 1:
            raise AssertionError(f"topk_score {label}: not one bf16 launch")
        wide = ops.topk_score(us16.float(), v16.float(), SERVE_K,
                              exclude=excl)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, wide)):
            raise AssertionError(f"topk_score {label}: not the bits of the "
                                 "fp32 kernel on the widened copies")
        same_as_single_calls(us16, v16, SERVE_K, excl, label)
        errs.append(ref.check_topk_score(
            got, plain_topk(us16, v16, SERVE_K, excl), us16.float(),
            v16.float(), f"topk_score {label}")[0])
        ms = time_ms(lambda: ktopk.topk_score_cuda(us16, v16, excl,
                                                   SERVE_K))
        f32 = time_ms(lambda: ktopk.topk_score_cuda(us, v, excl, SERVE_K))
        plain = time_ms(lambda: ref.topk_score_ref(us16, v16, excl,
                                                   SERVE_K))
        B = us.shape[0]
        n_bytes = 2 * (B * S * K + S * N * K) + 4 * B * N + 12 * B * SERVE_K
        b_ms, b_by = bound(n_bytes, 2 * B * S * N * K + 3 * B * S * N,
                           PEAK_BF16_FLOPS)
        print(f"  topk_score {label}: {ms:.3f} ms (fp32 kernel {f32:.3f} "
              f"ms), bitwise the fp32 kernel on the widened copies and "
              f"{SERVE_SLOTS} calls with B=1; plain {plain:.3f} ms; bound "
              f"{b_ms:.3f} ms by {b_by}")
        for key, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32),
                         ("bound_ms", b_ms)):
            entry[key] += val
        by[b_by] += b_ms
    entry["bound_by"] = max(by, key=by.get)
    entry["max_abs_err"] = max(errs)
    return entry


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
    saver, = sess._make_savers()
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
        want = {**dict.fromkeys(counts, 0), "topk_score": 2}
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
    Returns the ``topk_score`` and ``topk_score_bf16`` entries of the
    kernels line."""
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
        check_launches("serving", counts,
                       {"gram": 2 * sweeps, "sddmm": 2 * nsamples,
                        "sddmm_gathered": sweeps,
                        "topk_score": sum(p["steps"] + 1 for p in paths)})
        print(f"serving path launches {counts} (gram 2 per sweep; the "
              "gathered sddmm 1 per sweep; sddmm 1 per sample in the "
              "session and 1 per sample in the reload; topk_score 1 per "
              "server step, the first request's included)")

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
        entry16 = topk_bf16(shapes, check, counts["topk_score_bf16"])
        del sess, cache, shapes, us, v, excl
        torch.cuda.empty_cache()
        serve_store512(seed)
        return entry, entry16
    finally:
        shutil.rmtree(store, ignore_errors=True)


# the rest of the sweep at the reference's production cells
# (src/repro/launch/mf_dryrun.py:114-127), compounds cut as for the slice
MACAU_FEATURES, MACAU_BITS = 2048, 50    # ECFP bits, bits set a compound
MACAU_SWEEPS = (3, 4)                    # burn-in, saved samples
MACAU_HELDOUT, MACAU_REQUESTS = 1024, 64
PROBIT_SWEEPS = (3, 2)
DENSE = (131072, 4096)
DENSE_SWEEPS = 4
GFA = (131072, (8192, 4096, 2048), 32)   # samples, views, K
GFA_SWEEPS = 3
CHAINS = (16384, 2, 3)                   # compounds, chains, sweeps
PLANTED_RANK = 16


def with_values(mat, vals):
    """``mat``'s pattern with new values ``vals`` (one per COO entry):
    the padded rows and columns take them through the COO's flat
    positions (padding entries land in the one-past-end slot)."""
    import dataclasses
    import torch
    vals = vals * mat.coo_mask

    def scatter(padded, pos):
        flat = torch.zeros(padded.val.numel() + 1, device=vals.device)
        flat[pos.long()] = vals
        return dataclasses.replace(padded,
                                   val=flat[:-1].view_as(padded.val))

    return dataclasses.replace(mat, rows=scatter(mat.rows, mat.coo_rpos),
                               cols=scatter(mat.cols, mat.coo_cpos),
                               coo_v=vals)


def macau_data(train, seed):
    """Side information and values for ``macau_chembl``: 2,048-bit
    binary fingerprints with about 50 bits set a compound, a planted
    link (compound factor = fingerprint @ B, rank 16) and values at the
    slice's observed entries plus 0.3 noise; 1,024 more compounds held
    out of training with their fingerprints and true values.  Drawn on
    the card from ``seed``."""
    import math
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    D, n, m = MACAU_FEATURES, train.n_rows, train.n_cols
    side = (torch.rand(n + MACAU_HELDOUT, D, device="cuda", generator=g)
            < MACAU_BITS / D).float()
    B = torch.randn(D, PLANTED_RANK, device="cuda",
                    generator=g) / math.sqrt(MACAU_BITS)
    V = torch.randn(m, PLANTED_RANK, device="cuda", generator=g)
    U = side @ B
    i, j, step = train.coo_i, train.coo_j, 1 << 20
    vals = torch.cat([torch.linalg.vecdot(U.index_select(0, i[a:a + step]),
                                          V.index_select(0, j[a:a + step]))
                      for a in range(0, i.shape[0], step)])
    vals += NOISE * torch.randn(vals.shape, device="cuda", generator=g)
    return (side[:n].contiguous(), side[n:].contiguous(),
            with_values(train, vals), U[n:] @ V.T)


def phase_macau(train, seed: int):
    """``macau_chembl``: the slice's compounds and widths with 2,048-bit
    side information through the Macau prior; a save_freq store, its
    reload, ``predict_new`` for held-out compounds and cold-start
    requests through ``RecommendServer(features=)``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder, PredictSession
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RecommendServer
    from repro_torch.obs import Histogram, percentile_summary

    t0 = time.perf_counter()
    side, side_new, mat, truth_new = macau_data(train, seed)
    torch.cuda.synchronize()
    print(f"macau data: side {tuple(side.shape)}, "
          f"{float(side.sum(1).mean()):.1f} bits a compound, "
          f"{side.numel() * 4 / 1e9:.2f} GB on the card; "
          f"{MACAU_HELDOUT} held-out compounds; "
          f"{time.perf_counter() - t0:.1f} s")
    burnin, nsamples = MACAU_SWEEPS
    sweeps = burnin + nsamples
    store = tempfile.mkdtemp(prefix="chip_smoke_macau_")
    try:
        ops.reset_launch_counts()
        b = ModelBuilder(num_latent=128)
        b.add_entity("compound", train.n_rows, side_info=side)
        b.add_entity("protein", train.n_cols)
        b.add_block("compound", "protein", mat, noise=AdaptiveGaussian())
        sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed,
                         save_freq=1, save_dir=store)
        res, ms, peak = run_timed(sess)
        counts = ops.launch_counts()
        check_finite("macau", res)
        check_launches("macau session", counts,
                       {"gram": 2 * sweeps, "sddmm_gathered": sweeps})
        trace = [round(v, 6) for v in res.rmse_train_trace]
        med = sweep_summary("macau", ms, peak,
                            f"; rmse_train {trace}; launches {counts}")
        profile_sweep(sess.model, sess.data, res.state, med,
                      "macau profile", top=8)
        # the hyper-sample alone, at the chain's last state
        prior = sess.model.entities[0].prior
        st = res.state
        FtF = sess.data.side_grams[0]
        hyp = time_ms(lambda: prior.sample_hyper(
            st.key, st.factors[0], st.hypers[0], side=side, FtF=FtF), n=5)
        ftf = time_ms(lambda: side.T @ side, n=3)
        print(f"  Macau hyper-sample: {hyp:.3f} ms a sweep (side^T side "
              f"held with the data, computed once when the builder makes "
              f"them: {ftf:.3f} ms; the reference recomputes it every "
              "sweep); beta_prec "
              f"{float(st.hypers[0]['beta_prec']):.4f}")
        del res, st, sess, b

        ps = PredictSession(store, cache_bytes=SERVE_CACHE_BYTES)
        F_new = side_new.cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = ps.predict_new("compound", F_new)
        new_s = time.perf_counter() - t0
        cache = ps.warm_cache()
        want = torch.zeros(pred.shape, dtype=torch.float64, device="cuda")
        for s_ in range(cache.n_samples):
            h = cache.hyper_at(0, s_)
            u = h["mu"].double()[None, :] + side_new.double() @ \
                h["beta"].double()
            want += u @ cache.factors[1][s_].double().T
        want /= cache.n_samples
        got = torch.from_numpy(pred).to("cuda")
        if pred.shape != (MACAU_HELDOUT, train.n_cols) \
                or not torch.isfinite(got).all():
            raise AssertionError(f"macau: predict_new gave {pred.shape}")
        err = (got.double() - want).abs().max().item()
        if err > 1e-4 * (1.0 + want.abs().max().item()):
            raise AssertionError(f"macau: predict_new differs from the "
                                 f"fp64 formula by {err:.3e}")
        rmse = (got - truth_new).square().mean().sqrt().item()
        zero = truth_new.square().mean().sqrt().item()
        print(f"  predict_new for {MACAU_HELDOUT} held-out compounds x "
              f"{train.n_cols} proteins: {new_s:.2f} s (the cache's warm "
              f"included, {ps.num_samples} samples); max |diff| vs "
              f"mean_s (mu_s + F beta_s) V_s^T in fp64 {err:.3e}; RMSE "
              f"against the planted values {rmse:.4f} (predicting 0: "
              f"{zero:.4f})")

        block = ("compound", "protein")
        srv = RecommendServer(ps, slots=SERVE_SLOTS, k=SERVE_K, block=block)
        srv.submit(features=F_new[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.run()
        first_ms = (time.perf_counter() - t0) * 1e3
        srv.obs.reset()
        reqs = {srv.submit(features=F_new[q]): q
                for q in range(MACAU_REQUESTS)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {r["id"]: r for r in srv.run()}
        wall = (time.perf_counter() - t0) * 1e3
        for rid, q in reqs.items():
            seq = ps.recommend(features=F_new[q], k=SERVE_K, block=block)
            for key in ("ids", "mean", "std"):
                if not same_bits(done[rid][key], getattr(seq, key)[0]):
                    raise AssertionError(
                        f"macau: cold-start request {q} {key} differs "
                        "from a sequential recommend(features=)")
        hists = srv.metrics_snapshot()["histograms"]
        ex = percentile_summary(Histogram.from_dict(hists["serve.execute_s"]))
        counts = ops.launch_counts()
        print(f"  cold start: first request {first_ms:.1f} ms; then "
              f"{MACAU_REQUESTS} requests by features, {SERVE_SLOTS} slots, "
              f"k={SERVE_K} over {train.n_cols} proteins in {wall:.1f} ms; "
              f"serve.execute_s p50 {ex['p50'] * 1e3:.3f} ms, p99 "
              f"{ex['p99'] * 1e3:.3f} ms; every answer bitwise a sequential "
              f"recommend(features=); macau path launches {counts}")
        if counts["topk_score"] < 1:
            raise AssertionError("macau: no topk_score launch")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def phase_probit(train, test, seed: int):
    """``probit_chembl``: the slice's entries as binary activities
    (value > 0) through probit noise; every augmentation draws its
    latents around the gathered sddmm's predictions at the padded
    slots."""
    import numpy as np
    import torch
    from repro_torch.core import ModelBuilder, ProbitNoise
    from repro_torch.kernels import ops
    mat = with_values(train, (train.coo_v > 0).float())
    test_b = (test[0], test[1], (test[2] > 0).astype(np.float32))
    burnin, nsamples = PROBIT_SWEEPS
    sweeps = burnin + nsamples
    ops.reset_launch_counts()
    b = ModelBuilder(num_latent=128)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", mat, test=test_b,
                noise=ProbitNoise())
    sess = b.session(burnin=burnin, nsamples=nsamples, seed=seed)
    res, ms, peak = run_timed(sess)
    counts = ops.launch_counts()
    check_finite("probit", res)
    # the gathered sddmm: one a half-sweep for the latents, one a sweep
    # for the residual; sddmm one a sample for the test set
    check_launches("probit", counts,
                   {"gram": 2 * sweeps, "sddmm_gathered": 3 * sweeps,
                    "sddmm": nsamples})
    trace = [round(v, 6) for v in res.rmse_train_trace]
    med = sweep_summary("probit", ms, peak,
                        f"; rmse_train {trace}; test AUC "
                        f"{res.auc_test:.4f}, rmse_test {res.rmse_test:.4f}"
                        f"; launches {counts}")
    if not np.isfinite(res.auc_test):
        raise AssertionError(f"probit: test AUC {res.auc_test}")
    profile_sweep(sess.model, sess.data, res.state, med, "probit profile",
                  top=8)
    del res, mat, sess
    torch.cuda.empty_cache()
    return med


def phase_dense(seed: int):
    """``dense_views``: one fully observed 131,072 x 4,096 block at
    K = 128 (a planted rank-16 product plus 0.3 noise, drawn on the
    card); every row shares one (K, K) Gram, so each half-sweep is one
    Cholesky and matrix solves."""
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    from repro_torch.kernels import ops
    N, C = DENSE
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    X = torch.randn(N, PLANTED_RANK, device="cuda", generator=g) @ \
        torch.randn(C, PLANTED_RANK, device="cuda", generator=g).T
    X += NOISE * torch.randn(X.shape, device="cuda", generator=g)
    ops.reset_launch_counts()
    b = ModelBuilder(num_latent=128)
    b.add_entity("sample", N).add_entity("feature", C)
    b.add_block("sample", "feature", X, noise=AdaptiveGaussian())
    del X
    sess = b.session(burnin=DENSE_SWEEPS, nsamples=0, seed=seed)
    res, ms, peak = run_timed(sess)
    check_finite("dense", res)
    check_launches("dense", ops.launch_counts(), {})
    tr = res.rmse_train_trace
    med = sweep_summary(f"dense {N} x {C}", ms, peak,
                        f"; rmse_train {[round(v, 6) for v in tr]}")
    if not min(tr[1:]) < tr[0]:
        raise AssertionError(f"dense: rmse_train never fell: {tr}")
    profile_sweep(sess.model, sess.data, res.state, med, "dense profile",
                  top=8)
    del res, b, sess
    torch.cuda.empty_cache()
    return med


def gfa_views(seed: int):
    """``gfa_views``' three dense views on the card and the number of
    components each view's planted loadings use: a K = 32 product of
    N(0, 1) samples and loadings that use 2 of every 3 components, plus
    0.1 noise."""
    import torch
    N, dims, K = GFA
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    Z = torch.randn(N, K, device="cuda", generator=g)
    views, planted = [], []
    for m, D in enumerate(dims):
        W = torch.randn(D, K, device="cuda", generator=g)
        W[:, torch.arange(K, device="cuda") % 3 == m] = 0.0
        planted.append(int((W != 0).any(0).sum()))
        X = Z @ W.T
        X += 0.1 * torch.randn(X.shape, device="cuda", generator=g)
        views.append(X)
    return views, planted


def phase_gfa(seed: int):
    """``gfa_views``: FixedNormal samples against three fully observed
    views with spike-and-slab loadings, K = 32; each view's planted
    loadings use 2 of every 3 components."""
    import torch
    from repro_torch.core import AdaptiveGaussian, ModelBuilder
    from repro_torch.kernels import ops
    N, dims, K = GFA
    views, planted = gfa_views(seed)
    b = ModelBuilder(num_latent=K)
    b.add_entity("samples", N, prior="fixednormal")
    for m, (D, X) in enumerate(zip(dims, views)):
        b.add_entity(f"view{m}", D, prior="spikeandslab")
        b.add_block("samples", f"view{m}", X, noise=AdaptiveGaussian())
    del views
    ops.reset_launch_counts()
    sess = b.session(burnin=GFA_SWEEPS, nsamples=0, seed=seed)
    res, ms, peak = run_timed(sess)
    check_finite("gfa", res)
    check_launches("gfa", ops.launch_counts(), {})
    active = [int((f != 0).any(0).sum()) for f in res.state.factors[1:]]
    trace = [round(v, 6) for v in res.rmse_train_trace]
    med = sweep_summary(
        f"gfa {N} samples x views {dims}, K={K}", ms, peak,
        f"; rmse_train (view 0) {trace}; active components per view "
        f"{active} (planted {planted})")
    profile_sweep(sess.model, sess.data, res.state, med, "gfa profile",
                  top=8)
    del res, b, sess
    torch.cuda.empty_cache()
    return med


def same_state(a, b) -> bool:
    """Every tensor of two ``MFState``s bitwise equal."""
    import torch
    return (torch.equal(a.key, b.key) and a.step == b.step
            and all(torch.equal(x, y) for x, y in zip(a.factors, b.factors))
            and all(torch.equal(ha[k], hb[k])
                    for ha, hb in zip(a.hypers, b.hypers) for k in ha)
            and all(torch.equal(na[k], nb[k])
                    for na, nb in zip(a.noises, b.noises) for k in na))


def phase_chains(seed: int):
    """Two chains of the probit model at 16,384 compounds (full widths):
    ``multi_chain_step`` loops over the chains, and each must be bitwise
    the single-chain run keyed ``chain_keys(seed, 2)[c]``."""
    import torch
    from repro_torch.core import (ModelBuilder, ProbitNoise, chain_keys,
                                  gibbs_step, init_chain_states, init_state,
                                  multi_chain_step, stack_states,
                                  unstack_state)
    n, C, sweeps = CHAINS
    train, _ = slice_data(n, seed, "cuda")
    b = ModelBuilder(num_latent=128)
    b.add_entity("compound", n).add_entity("protein", train.n_cols)
    b.add_block("compound", "protein",
                with_values(train, (train.coo_v > 0).float()),
                noise=ProbitNoise())
    model, data, _ = b.build()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stacked = stack_states(init_chain_states(model, data, seed, C))
    traces = []
    for _ in range(sweeps):
        stacked, m = multi_chain_step(model, data, stacked)
        traces.append(m)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    for c, key in enumerate(chain_keys(seed, C, "cuda")):
        st = init_state(model, data, key=key)
        for s_ in range(sweeps):
            st, m = gibbs_step(model, data, st)
            for name, v in m.items():
                if not torch.equal(traces[s_][name][c], v):
                    raise AssertionError(f"chains: chain {c} sweep {s_} "
                                         f"{name} differs")
        if not same_state(unstack_state(stacked, c), st):
            raise AssertionError(f"chains: chain {c} is not the single-"
                                 "chain run with its key")
    print(f"chains: {C} chains of the probit model at {n} compounds x "
          f"{train.n_cols} proteins, K=128, {sweeps} sweeps through "
          f"multi_chain_step in {multi_s:.2f} s; each chain bitwise the "
          "single-chain run keyed chain_keys(seed, 2)[c] (every state "
          "tensor, metrics)")


SESSIONS = (2, 2, 2)          # chains, burn-in, posterior samples
SESSIONS_REQUESTS = 16
GFA_SESSION_SWEEPS = (1, 1)


def phase_sessions(seed: int):
    """The session layer at the slice's widths (131,072 compounds x 8,192
    proteins, 64 a compound, K = 128) through ``TrainSession``: (a) two
    chains into a two-chain store with a recorder, each chain bitwise the
    single-chain run with its key; (b) the same run cut after one sample
    and resumed, bitwise (a); (c) the store reloaded by
    ``PredictSession``; (d) 16 requests through ``RecommendServer``, each
    bitwise a sequential ``recommend``; (e) one ``sweep`` span a sweep,
    and the chains bitwise a recorder-off run's; (f) ``GFASession`` on
    ``gfa_views``' data."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import (AdaptiveGaussian, GFASession,
                                  PredictSession, TrainSession, chain_keys,
                                  gibbs_step, init_state, unstack_state)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RecommendServer
    from repro_torch.obs import Recorder, percentile_summary

    C, burnin, nsamples = SESSIONS
    sweeps = burnin + nsamples
    train, test = slice_data(COMPOUNDS, seed, "cuda")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sessions_"))

    def session(nsamples, save_dir=None, recorder=None):
        s = TrainSession(num_latent=128, burnin=burnin, nsamples=nsamples,
                         seed=seed, chains=C, save_freq=1 if save_dir else 0,
                         save_dir=None if save_dir is None else str(save_dir),
                         recorder=recorder)
        s.add_train_and_test(train, test, noise=AdaptiveGaussian())
        return s

    try:
        def timed(sess):
            """(result, seconds, ms of each sweep; the first holds
            init_chain_states)."""
            stamps = []

            def stamp(info):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            sess.callbacks = tuple(sess.callbacks) + (stamp,)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sess.run()
            edges = [t0] + stamps
            return (out, time.perf_counter() - t0,
                    [(b - a) * 1e3 for a, b in zip(edges, edges[1:])])

        # (a) two chains into a store, traced
        rec = Recorder()
        ops.reset_launch_counts()
        res, store_s, sweep_ms = timed(session(nsamples, root / "a", rec))
        counts = ops.launch_counts()
        check_launches("sessions (a)", counts,
                       {"gram": 2 * C * sweeps, "sddmm": C * nsamples,
                        "sddmm_gathered": C * sweeps})
        check_finite("sessions (a)", res)
        if res.n_chains != C or len(res.chain_blocks) != C or                 res.predictions is None or                 not np.isfinite(res.predictions).all():
            raise AssertionError("sessions (a): not a pooled two-chain "
                                 "result")
        host_med = statistics.median(sweep_ms[1:])
        model, data = session(nsamples)._build()
        keys = chain_keys(seed, C, "cuda")
        for c in range(C):
            st = init_state(model, data, key=keys[c])
            for _ in range(sweeps):
                st, _ = gibbs_step(model, data, st)
            if not same_state(unstack_state(res.state, c), st):
                raise AssertionError(f"sessions (a): chain {c} is not the "
                                     "single-chain run keyed "
                                     f"chain_keys(seed, {C})[{c}]")
        del model, data, st
        on_disk = sum(f.stat().st_size for f in (root / "a").rglob("*")
                      if f.is_file())
        print(f"sessions (a): TrainSession(num_latent=128, chains={C}, "
              f"burnin={burnin}, nsamples={nsamples}, save_freq=1) in "
              f"{store_s:.2f} s, {on_disk / 1e9:.3f} GB on disk; sweeps "
              + ", ".join(f"{m:.1f}" for m in sweep_ms)
              + f" ms for {C} chains (the first with init_chain_states); "
              f"rmse_test {res.rmse_test:.6f} pooled over {C} x {nsamples}"
              f" draws; launches {counts}; each chain bitwise the "
              "single-chain run with its key")

        # (b) cut after one sample, resumed to two
        session(1, root / "b").run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = session(nsamples, root / "b").run(resume=True)
        resume_s = time.perf_counter() - t0
        if resumed.resumed_from != sweeps - 1:
            raise AssertionError(f"sessions (b): resumed_from "
                                 f"{resumed.resumed_from}, want {sweeps - 1}")
        for c in range(C):
            if not same_state(unstack_state(resumed.state, c),
                              unstack_state(res.state, c)):
                raise AssertionError(f"sessions (b): resumed chain {c} is "
                                     "not the uninterrupted chain")
        print(f"sessions (b): run(resume=True) from sweep "
              f"{resumed.resumed_from} in {resume_s:.2f} s (the restore "
              f"of {C} chains and {sweeps - resumed.resumed_from} sweep); "
              "both chains bitwise (a)'s")
        del resumed

        # (c) reload the two-chain store
        if not (root / "a" / "diagnostics.json").is_file():
            raise AssertionError("sessions (c): no diagnostics.json")
        sess = PredictSession(str(root / "a"), cache_bytes=SERVE_CACHE_BYTES)
        t0 = time.perf_counter()
        pred = sess.predict(test[0], test[1])
        reload_s = time.perf_counter() - t0
        np.testing.assert_allclose(pred, res.predictions, **RELOAD_TOL,
                                   err_msg="sessions (c): reload vs session")
        if sess.n_chains != C or sess.num_samples != C * nsamples:
            raise AssertionError(f"sessions (c): {sess.n_chains} chains, "
                                 f"{sess.num_samples} samples on disk")
        print(f"sessions (c): PredictSession over the {C}-chain store, "
              f"{sess.num_samples} pooled samples, predict at {pred.size} "
              f"entries in {reload_s:.2f} s; max |diff| vs the pooled "
              f"in-session mean {np.abs(pred - res.predictions).max():.3e}"
              f" ({RELOAD_TOL}); diagnostics.json written")

        # (d) serve from the pooled store
        rng = np.random.default_rng(seed + 2)
        users = rng.choice(train.n_rows, SESSIONS_REQUESTS, replace=False)
        excl = observed_items(train.rows, users)
        srv = RecommendServer(sess, slots=SERVE_SLOTS, k=SERVE_K,
                              block=("rows", "cols"))
        ops.reset_launch_counts()
        reqs = {srv.submit(user=int(u), exclude=e): (int(u), e)
                for u, e in zip(users, excl)}
        done = {r["id"]: r for r in srv.run()}
        served = ops.launch_counts()["topk_score"]
        if not served:
            raise AssertionError("sessions (d): no topk_score launch")
        for rid, (u, e) in reqs.items():
            seq = sess.recommend(user=u, k=SERVE_K,
                                 block=("rows", "cols"), exclude=[e])
            r = done[rid]
            for key in ("ids", "mean", "std"):
                if not same_bits(r[key], getattr(seq, key)[0]):
                    raise AssertionError(f"sessions (d): request {rid} "
                                         f"{key} differs from recommend")
            if (r["ids"] < 0).any() or np.isin(r["ids"], e).any():
                raise AssertionError(f"sessions (d): bad answer {rid}")
        print(f"sessions (d): {SESSIONS_REQUESTS} requests through "
              f"RecommendServer ({SERVE_SLOTS} slots, k={SERVE_K}) from the "
              f"pooled store in {served} topk_score launches, each bitwise "
              "a sequential recommend")
        del sess, srv

        # (e) the trace, and the chains without a recorder
        spans = [e for e in rec.trace()["traceEvents"]
                 if e["name"] == "sweep"]
        if [e["args"]["sweep"] for e in spans] != list(range(sweeps)):
            raise AssertionError(f"sessions (e): sweep spans {spans}")
        p50 = percentile_summary(rec.histogram("session.sweep_s"))["p50"]
        off, _, off_ms = timed(session(nsamples,
                                       recorder=Recorder(enabled=False)))
        for c in range(C):
            if not same_state(unstack_state(off.state, c),
                              unstack_state(res.state, c)):
                raise AssertionError(f"sessions (e): chain {c} differs "
                                     "with the recorder off")
        rhat = spans[-1]["args"].get("rhat_rmse_train_0")
        print(f"sessions (e): {len(spans)} sweep spans, one a sweep; "
              f"session.sweep_s p50 {p50 * 1e3:.1f} ms (histogram bucket "
              f"interpolation) beside the host median {host_med:.1f} ms "
              f"after the first sweep; last span's rhat_rmse_train_0 "
              f"{rhat}; with the recorder off both chains are bitwise the "
              "same (that run, without a store: sweeps "
              + ", ".join(f"{m:.1f}" for m in off_ms) + " ms, median after "
              f"the first {statistics.median(off_ms[1:]):.1f} ms)")
        del res, off, train, test
        torch.cuda.empty_cache()

        # (f) GFASession at gfa_views' widths
        N, dims, K = GFA
        views, _ = gfa_views(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = GFASession(views, num_latent=K, burnin=GFA_SESSION_SWEEPS[0],
                       nsamples=GFA_SESSION_SWEEPS[1], seed=seed).run()
        gfa_s = time.perf_counter() - t0
        if g["Z"].shape != (N, K) or not np.isfinite(g["Z"]).all():
            raise AssertionError(f"sessions (f): Z {g['Z'].shape}")
        for W, D in zip(g["W"], dims):
            if W.shape != (D, K) or not np.isfinite(W).all():
                raise AssertionError(f"sessions (f): W {W.shape}")
        print(f"sessions (f): GFASession {N} samples x views {dims}, K={K},"
              f" {sum(GFA_SESSION_SWEEPS)} sweeps in {gfa_s:.2f} s; Z "
              f"{g['Z'].shape} and W {[w.shape for w in g['W']]} finite; "
              f"rmse_train (view 0) {[round(v, 6) for v in g['rmse_train'][0]]}")
        del g, views
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the LM slice: Qwen3-4B at full width and depth, random weights
DIST_SWEEPS = (1, 3)          # untimed first sweep, timed sweeps
DIST_PROBIT = 16384           # compounds of the probit run
DIST_GLOO_SWEEPS = 2
DIST_TOL = dict(rtol=2e-4, atol=2e-4)   # the reference's distributed tol


def _dist_model(train, device, noise, bf16_gather: bool = False):
    from repro_torch.core import ModelBuilder
    b = ModelBuilder(num_latent=128, device=device, bf16_gather=bf16_gather)
    b.add_entity("compound", train.n_rows)
    b.add_entity("protein", train.n_cols)
    b.add_block("compound", "protein", train, noise=noise)
    model, data, _ = b.build()
    return model, data


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def wire_bytes(census, contract) -> int:
    """The bytes a rank received in a sweep, from its census: the
    exchange's elements sent (an all-gather receives S - 1 times what it
    sends, a ring hop what it sends) at the contract's item size, plus
    ``contract_wire_bytes``' estimate of the all-reduces."""
    S = contract.n_shards
    if S <= 1:
        return 0
    item = 2 if contract.wire_dtype == "bf16" else 4
    recv = census["wire_elems"] * item * (
        S - 1 if contract.pipeline == "eager" else 1)
    reduces = contract.all_reduces * contract.max_reduce_elems * 4 * (
        (S - 1) / S)
    return int(recv + reduces)


def check_wire(label, model, census, contract):
    """The exchange in the contract's dtype, at ``contract_wire_bytes``."""
    from repro_torch.analysis.contract import contract_wire_bytes
    moved = contract.all_gathers + contract.collective_permutes
    if moved and census["wire_dtypes"] != [contract.wire_dtype]:
        raise AssertionError(f"{label}: wire {census['wire_dtypes']}, "
                             f"contract {contract.wire_dtype}")
    got, want = wire_bytes(census, contract), contract_wire_bytes(model,
                                                                  contract)
    if got != want:
        raise AssertionError(f"{label}: {got} bytes on the wire, "
                             f"contract_wire_bytes {want}")
    return got


def _dist_chain(label, model, data, step, ldata, st, world, pipe):
    """1 + 3 sweeps of a placed chain: (sweep-1 state, last state, ms
    of the timed sweeps, launches); each sweep's census held against
    ``contract_for`` (its wire dtype and ``contract_wire_bytes`` too) and
    the kernels' operands checked 16-byte aligned."""
    import torch
    from repro_torch.analysis.contract import assert_census, contract_for
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    contract = contract_for(model, (world,), pipe)
    ops.reset_launch_counts()
    first, ms, rmse = None, [], []
    for s in range(sum(DIST_SWEEPS)):
        D.reset_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(ldata, st)
        torch.cuda.synchronize()
        if s >= DIST_SWEEPS[0]:
            ms.append((time.perf_counter() - t0) * 1e3)
        assert_census(contract, D.census(), where=f"{label} sweep {s}")
        check_wire(f"{label} sweep {s}", model, D.census(), contract)
        rmse.append(float(m["rmse_train_0"]))
        if s == 0:
            first = step.gather_state(st)
    counts = ops.launch_counts()
    if not _aligned(*st.factors) or not all(
            _aligned(p.idx, p.val, p.mask) for blk in ldata.blocks
            for p in (blk.rows, blk.cols)):
        raise AssertionError(f"{label}: a kernel operand of the shard is "
                             "not 16-byte aligned")
    return first, st, ms, counts, contract, rmse


def _held(label, got, want, hold: str) -> str:
    """Factors of two states held ``"bitwise"``, ``"elementwise"``
    within DIST_TOL, or only reported (``"report"``)."""
    import torch
    worst, moved, num, den = 0.0, 0, 0.0, 0.0
    for a, b in zip(got.factors, want.factors):
        diff = (a - b).abs()
        if hold == "bitwise" and not torch.equal(a, b):
            raise AssertionError(f"{label}: not bitwise the single-device "
                                 f"sweep ({int((diff > 0).sum())} elements)")
        bad = diff > DIST_TOL["atol"] + DIST_TOL["rtol"] * b.abs()
        if hold == "elementwise" and bad.any():
            raise AssertionError(f"{label}: {int(bad.sum())} elements "
                                 f"beyond {DIST_TOL}")
        worst = max(worst, diff.max().item())
        moved += int((diff > 0).sum())
        num += float((a - b).norm()) ** 2
        den += float(b.norm()) ** 2
    return ("bitwise" if moved == 0 else
            f"max |diff| {worst:.3e}, {moved} elements moved, relative "
            f"Frobenius {(num / den) ** 0.5:.3e}")


def dist_rank(rank, world, out, seed):
    """One rank of the card's world: the slice under eager and ring and
    probit under eager, beside the single-device sweep; then
    ``TrainSession(mesh=...)`` into a store.  Rank 0 prints the report
    and writes the launch counts to ``out``."""
    import statistics as stats_
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import (AdaptiveGaussian, PredictSession,
                                  ProbitNoise, TrainSession, gibbs_step,
                                  init_state)
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    dev = f"cuda:{torch.cuda.current_device()}"
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    say(f"distributed: world of {world} rank(s), NCCL, mesh "
        f"{tuple(mesh.mesh.shape)} ('data',); backend "
        f"{torch.distributed.get_backend()}", flush=True)
    train, test = slice_data(COMPOUNDS, seed, dev)
    launches = {}
    for label, mat, noise, pipes, bf16 in (
            ("slice", train, AdaptiveGaussian(), ("eager", "ring"), False),
            ("probit", None, ProbitNoise(), ("eager",), False),
            ("slice bf16_gather", train, AdaptiveGaussian(),
             ("eager", "ring"), True)):
        if mat is None:
            small, _ = slice_data(DIST_PROBIT, seed, dev)
            mat = with_values(small, (small.coo_v > 0).float())
        model, data = _dist_model(mat, dev, noise, bf16)
        st0 = init_state(model, data, seed)
        single_ms, single_rmse, st = [], [], st0
        for s in range(sum(DIST_SWEEPS)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = gibbs_step(model, data, st)
            torch.cuda.synchronize()
            single_rmse.append(float(m["rmse_train_0"]))
            if s == 0:
                single_first = st
            else:
                single_ms.append((time.perf_counter() - t0) * 1e3)
        single_last = st
        line = (f"distributed {label} ({mat.n_rows} x {mat.n_cols}, K=128): "
                f"single-device median {stats_.median(single_ms):.1f} ms")
        firsts = {}
        for pipe in pipes:
            step, ldata, lst = D.make_distributed_step(model, mesh, data,
                                                       st0, pipe)
            assert step.supported
            first, lst, ms, counts, contract, rmse = _dist_chain(
                f"{label}/{pipe}", model, data, step, ldata, lst, world,
                pipe)
            firsts[pipe] = first
            launches[f"{label}_{pipe}"] = counts
            sweeps = sum(DIST_SWEEPS)
            if bf16:
                # the bf16 entries, the residuals through the padded
                # bf16 x bf16 one; no fp32 gathered entry
                want = {"gram_gathered_bf16": 2 * sweeps,
                        "sddmm_padded_bf16": sweeps,
                        "sddmm_gathered_bf16": 0, "gram": 0,
                        "sddmm_gathered": 0}
            else:
                want = {"gram": 2 * sweeps,
                        "sddmm_gathered": (3 if label == "probit" else 1)
                        * sweeps}
            got = {k: counts[k] for k in want}
            if got != want or counts["sddmm"]:
                raise AssertionError(f"distributed {label}/{pipe}: launches "
                                     f"{counts}, want {want}")
            # one rank: the first sweep is the single-device sweep's bits
            # (probit's every sweep: its alpha never moves); later slice
            # sweeps move by the ULPs of the adaptive alpha, summed over
            # the padded slots, within the reference's 2e-4.  More ranks
            # sum the moments in another order too, which a K = 128
            # chain (probit's tails most) carries past an elementwise
            # bound: there the rmse of each sweep is held at rtol 1e-3
            # and the factors are reported
            # bf16: after the first sweep an element of a factor near a
            # bf16 rounding boundary may round the other way in one of
            # the two (their fp32 factors differ by the alpha's ULPs),
            # so later sweeps are reported
            hold1 = "bitwise" if world == 1 else "report"
            hold = ("report" if world > 1 or bf16 else
                    "bitwise" if label == "probit" else "elementwise")
            bits1 = _held(f"{label}/{pipe} sweep 1", first, single_first,
                          hold1)
            bits = _held(f"{label}/{pipe} sweep {sweeps}",
                         step.gather_state(lst), single_last, hold)
            for s_, (a, b) in enumerate(zip(rmse, single_rmse)):
                if abs(a - b) > 1e-3 * abs(b):
                    raise AssertionError(
                        f"{label}/{pipe} sweep {s_}: rmse_train {a} against "
                        f"the single-device {b}")
            line += (f"; {pipe} median {stats_.median(ms):.1f} ms (sweeps "
                     + ", ".join(f"{t:.1f}" for t in ms)
                     + f"), sweep 1 {bits1}, sweep {sweeps} vs single "
                     f"{bits}; census a sweep {contract.all_gathers} "
                     f"all-gathers, {contract.collective_permutes} hops, "
                     f"{contract.all_reduces} all-reduces (max "
                     f"{contract.max_reduce_elems} elements), wire "
                     f"{contract.wire_dtype}, as contract_for; launches "
                     + str(got))
            del step, ldata, lst, first
            torch.cuda.empty_cache()
        if "ring" in firsts and not all(
                torch.equal(a, b) for a, b in zip(firsts["ring"].factors,
                                                  firsts["eager"].factors)):
            raise AssertionError(f"distributed {label}: ring's first sweep "
                                 "is not eager's")
        say(line, flush=True)
        del model, data, st0, st, single_first, single_last, firsts
        torch.cuda.empty_cache()

    # the session layer on the mesh: 1 + 1 sweeps into a store
    store = str(Path(out) / "store")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    sess = TrainSession(num_latent=128, burnin=1, nsamples=1, seed=seed,
                        device=dev, save_freq=1, save_dir=store, mesh=mesh)
    sess.add_train_and_test(train, test=test, noise=AdaptiveGaussian())
    res = sess.run()
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_finite("distributed session", res)
    if counts["gram"] != 4 or counts["sddmm_gathered"] != 2:
        raise AssertionError(f"distributed session: launches {counts}")
    if rank == 0:
        ps = PredictSession(store, device=dev)
        pred = ps.predict(test[0], test[1])
        err = float(abs(pred - res.predictions).max())
        if err > RELOAD_TOL["atol"] + RELOAD_TOL["rtol"] * float(
                abs(res.predictions).max()):
            raise AssertionError(f"distributed session: the store's "
                                 f"predictions differ by {err}")
        say(f"distributed session: TrainSession(mesh=world of {world}, "
            f"burnin=1, nsamples=1, save_freq=1) in {session_s:.2f} s; "
            f"rmse_test {res.rmse_test:.6f}; PredictSession over its store "
            f"at {test[0].size} entries, max |diff| {err:.3e}; launches "
            f"{ {k: counts[k] for k in ('gram', 'sddmm', 'sddmm_gathered')} }",
            flush=True)
        (Path(out) / "launches.json").write_text(json.dumps(launches))


def dist_gloo_probe(rank, world, out):
    """Whether gloo takes CUDA tensors for the sweep's collectives, with
    both ranks on the one card: fp32 all-gather and all-reduce, then in
    bf16 the eager exchange's all-gather and, last, the ring's hop
    (``batch_isend_irecv``).  Rank 0 appends each step it passed to
    ``out/probe.txt`` before the next, since gloo may end a rank's
    process on a tensor it does not take."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))

    def passed(step):
        if rank == 0:
            with open(Path(out) / "probe.txt", "a") as f:
                f.write(step + "\n")

    x = torch.full((4, 8), float(rank), device="cuda")
    full = torch.empty((4 * world, 8), device="cuda")
    dist.all_gather_into_tensor(full, x)
    y = torch.ones(3, device="cuda")
    dist.all_reduce(y)
    if full[:, 0].tolist() != [float(r) for r in range(world)
                               for _ in range(4)] or y.tolist() != [world] * 3:
        raise AssertionError(f"gloo over CUDA tensors: wrong values "
                             f"{full[:, 0].tolist()} {y.tolist()}")
    passed("fp32")
    x = torch.full((4, 8), rank + 0.5, device="cuda", dtype=torch.bfloat16)
    full = torch.empty((4 * world, 8), device="cuda", dtype=torch.bfloat16)
    dist.all_gather_into_tensor(full, x)
    got = full[:, 0].float().tolist()
    if got != [r + 0.5 for r in range(world) for _ in range(4)]:
        raise AssertionError(f"gloo bf16 all_gather: {got}")
    passed("all_gather")
    nxt = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank - 1) % world),
            dist.P2POp(dist.irecv, nxt, (rank + 1) % world)]):
        req.wait()
    if float(nxt[0, 0]) != (rank + 1) % world + 0.5:
        raise AssertionError(f"gloo bf16 ring_hop: {float(nxt[0, 0])}")


def dist_gloo_rank(rank, world, out, seed, bf16_pipes):
    """Two ranks on the one card through gloo: each holds half the
    slice's rows at an offset, in tensors of its own.  fp32 under eager,
    then ``bf16_gather`` under the pipelines of ``bf16_pipes`` (those
    whose collective gloo takes in bf16), the wire held at
    ``contract_wire_bytes`` in bf16.
    The first fp32 sweep is held within 2e-4 of the single-device
    sweep's; every sweep's rmse at rtol 1e-3 (the other factors
    reported: see ``dist_rank``)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.analysis.contract import assert_census, contract_for
    from repro_torch.core import AdaptiveGaussian, gibbs_step, init_state
    from repro_torch.core import distributed as D
    dev = f"cuda:{torch.cuda.current_device()}"
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    train, _ = slice_data(COMPOUNDS, seed, dev)
    runs = [(False, "eager")] + [(True, pipe) for pipe in bf16_pipes]
    for bf16, pipe in runs:
        model, data = _dist_model(train, dev, AdaptiveGaussian(), bf16)
        st0 = init_state(model, data, seed)
        step, ldata, st = D.make_distributed_step(model, mesh, data, st0,
                                                  pipe)
        contract = contract_for(model, (world,), pipe)
        ms, rmse, gathered, wire = [], [], [], 0
        for s in range(DIST_GLOO_SWEEPS):
            D.reset_census()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(ldata, st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            assert_census(contract, D.census(), where=f"gloo sweep {s}")
            wire = check_wire(f"gloo sweep {s}", model, D.census(),
                              contract)
            rmse.append(float(m["rmse_train_0"]))
            gathered.append(step.gather_state(st))
        if not _aligned(*st.factors):
            raise AssertionError("gloo: a factor shard is not 16-byte "
                                 "aligned")
        del step, ldata, st
        if rank == 0:
            want, report = st0, []
            for s in range(DIST_GLOO_SWEEPS):
                want, m = gibbs_step(model, data, want)
                # bf16: the two ranks sum the hyper moments in another
                # order, so the first half-sweep's fp32 factor moves by
                # ULPs and a few elements of its bf16 copy round the
                # other way; the later half-sweep carries that past an
                # elementwise bound, so bf16 factors are reported
                hold = "elementwise" if s == 0 and not bf16 else "report"
                report.append(f"sweep {s + 1} "
                              + _held(f"gloo sweep {s + 1}", gathered[s],
                                      want, hold))
                if abs(rmse[s] - float(m["rmse_train_0"])) > 1e-3 * float(
                        m["rmse_train_0"]):
                    raise AssertionError(
                        f"gloo sweep {s + 1}: rmse_train {rmse[s]} against "
                        f"{m['rmse_train_0']}")
            print(f"distributed (b): world of {world} ranks on one card "
                  f"through gloo, {'bf16_gather, ' if bf16 else ''}{pipe}, "
                  f"{DIST_GLOO_SWEEPS} sweeps of the slice (ranks at rows 0 "
                  f"and {COMPOUNDS // world}): sweeps "
                  + ", ".join(f"{t:.1f}" for t in ms) + " ms; wire "
                  f"{contract.wire_dtype}, {wire} bytes a sweep received by "
                  "a rank = contract_wire_bytes; vs the single-device "
                  "sweeps: " + "; ".join(report), flush=True)
        del model, data, st0, gathered
        torch.cuda.empty_cache()


def phase_distributed(seed: int):
    """The distributed sweep on the card: (a) a world of
    ``torch.cuda.device_count()`` ranks with NCCL runs the slice at full
    width under eager and ring, 1 + 3 sweeps, beside the single-device
    sweep (at one rank the first sweep bitwise it, ring's bitwise
    eager's, the fourth within 2e-4), probit at 16,384 compounds under
    eager, the slice with ``bf16_gather`` under eager and ring, each
    sweep's collectives held against ``contract_for`` (the wire's dtype
    and ``contract_wire_bytes`` too), and ``TrainSession(mesh=...)`` for
    1 + 1 sweeps into a store; (b) where gloo takes CUDA tensors (probed
    first in one world, fp32 and then each bf16 collective), two ranks
    on the one card through gloo: eager, then bf16 under the pipelines
    whose collective gloo takes.  Returns the kernels'
    launches on the distributed path."""
    import tempfile
    import torch
    from repro_torch.runtime import run_world
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = run_world("chip_smoke:dist_rank", n, device_type="cuda",
                         workdir=Path(tmp) / "world", args=(tmp, seed),
                         extra_paths=[str(ROOT)], timeout_s=600)
        print(outs[0], end="")
        print(f"distributed (a): world of {n} in "
              f"{time.perf_counter() - t0:.1f} s (ranks' start included)")
        launches = json.loads((Path(tmp) / "launches.json").read_text())
        # one world probes gloo: fp32, then the bf16 exchange of each
        # pipeline; the bf16 runs take the pipelines whose collective it
        # takes (the ring's hop, the last step, only if the world ended
        # well)
        try:
            run_world("chip_smoke:dist_gloo_probe", 2, device_type="cuda",
                      backend="gloo", local_ranks=[0, 0],
                      workdir=Path(tmp) / "probe", args=(tmp,),
                      extra_paths=[str(ROOT)], timeout_s=120)
            err = None
        except RuntimeError as exc:
            tail = [line for line in str(exc).splitlines() if line.strip()]
            err = tail[-1] if tail else str(exc)
        probe = Path(tmp) / "probe.txt"
        done = probe.read_text().split() if probe.exists() else []
        if "fp32" not in done:
            print("distributed (b): left out: gloo does not take CUDA "
                  f"tensors here: {err}")
            return launches
        pipes = []
        for what, pipe, ok in (("all_gather", "eager", "all_gather" in done),
                               ("ring_hop", "ring", err is None)):
            if ok:
                pipes.append(pipe)
                found = "taken"
            elif what == "ring_hop" and "all_gather" not in done:
                found = "not reached"
            else:
                found = f"refused ({err})"
            print(f"distributed (b): gloo on bf16 CUDA tensors, {what}: "
                  f"{found}")
        t0 = time.perf_counter()
        outs = run_world("chip_smoke:dist_gloo_rank", 2, device_type="cuda",
                         backend="gloo", local_ranks=[0, 0],
                         workdir=Path(tmp) / "gloo",
                         args=(tmp, seed, pipes),
                         extra_paths=[str(ROOT)], timeout_s=600)
        print(outs[0], end="")
        print(f"distributed (b): in {time.perf_counter() - t0:.1f} s")
    return launches


LM_ARCH = "qwen3_4b"
LM_PREFILL = (4, 4096)      # prompts x tokens: train_4k's sequence length
LM_GEN = (8, 128, 32)       # prompts, prompt tokens, new tokens
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS = 8, 512, 16
LM_TOL = dict(rtol=0.08, atol=0.08)   # decode vs forward, test_models.py


def visible_pairs(Sq, Sk, causal=True, window=0):
    """The (query, key) pairs a call computes: every one without the
    causal mask, else from position 0 a query's keys up to its own (the
    ``window`` of them; 0: all)."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, s + 1, window or Sk) for s in range(Sq))


def flash_bound(q_shape, kv_shape, hdv=None, window=0, causal=True):
    """(ms, by, operations) of one bf16 call (causal from position 0
    unless ``causal`` is False), v ``hdv`` wide (default: q and k's
    width hd), a query seeing the ``window`` keys up to its own (0:
    all): q, k, v read once, out written once; 2 (hd + hdv) operations
    per visible (query, key) pair and head, at the tensor cores' bf16
    rate."""
    B, Sq, H, hd = q_shape
    Sk, KVH = kv_shape[1], kv_shape[2]
    hdv = hd if hdv is None else hdv
    pairs = visible_pairs(Sq, Sk, causal, window)
    n_bytes = 2 * (B * Sq * H * (hd + hdv) + B * Sk * KVH * (hd + hdv))
    n_ops = 2 * B * H * (hd + hdv) * pairs
    return bound(n_bytes, n_ops, PEAK_BF16_FLOPS) + (n_ops,)


def sdpa(q, k, v, causal=True):
    """PyTorch's fused attention on the same inputs, the yardstick
    (causal from position 0 with Sq = Sk, or without a mask; GQA)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


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


def profile_once(fn, label, sums=None):
    """fn() under torch.profiler: wall, device busy, idle share and the
    kernels with the most device time, and those whose names hold a key
    of ``sums``, which gets each key's device ms; returns the busy ms."""
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
    named = [e for e in kernels[8:] if any(k in e.key for k in sums or ())]
    for e in kernels[:8] + named:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    for k in sums or ():
        sums[k] = sum(e.self_device_time_total for e in kernels
                      if k in e.key) / 1e3
    return busy


def decode_agreement(dec, par, label: str) -> float:
    """Print how decode's logits (B, S, V) follow the forward's and
    return the share of rows where decode's argmax is a maximiser of the
    forward's logits."""
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
    print(f"{label}: decode's argmax a maximiser of forward's logits in "
          f"{agree:.4f} of rows (first-index argmax agreement {first:.4f}; "
          f"rows whose top two forward logits tie exactly in bf16 "
          f"{ties:.4f}); max |diff| {diff.max().item():.4f}, median |diff| "
          f"{diff.median().item():.5f}, share of logits within rtol/atol "
          f"0.08 {within:.6f}; forward logits std "
          f"{par.float().std().item():.3f}")
    return agree


def phase_lm(seed: int, flash_entry, arch: str = LM_ARCH,
             source: str = "flash_sm90", agree_min=0.95):
    """An LM's serving path at its full width and depth (Qwen3-4B by
    default): every flash launch on ``source``, decode's argmax a
    maximiser of forward's logits in more than ``agree_min`` of the
    prompt positions (None: printed, not held; a MoE model's also at a
    capacity at which no group drops a token)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as tserve
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.obs import Histogram, percentile_summary

    cfg = get_config(arch)
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
          f"in {time.perf_counter() - t0:.2f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    if cfg.n_experts:
        print(f"  MoE: {cfg.n_experts} routed experts top-{cfg.top_k} + "
              f"{cfg.n_shared_experts} shared, d_ff_expert "
              f"{cfg.d_ff_expert}, groups of {cfg.router_group} tokens, "
              f"capacity factor {cfg.capacity_factor}; MLA: kv_lora "
              f"{cfg.kv_lora_rank}, nope {cfg.qk_nope_dim}, rope "
              f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}; "
              f"{len(cfg.prologue)} dense prologue layer(s); fp32 matmul "
              f"TF32 {torch.backends.cuda.matmul.allow_tf32}, precision "
              f"{torch.get_float32_matmul_precision()}")
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
        logits, aux = forward(model, cfg, {"tokens": toks})
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
    if cfg.n_experts and not (torch.isfinite(aux) and float(aux) > 0):
        raise AssertionError(f"forward: MoE aux loss {float(aux)}")
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    n_fwd = 4
    by_source = {n: cfg.n_layers * n_fwd * (n == source)
                 for n in kflash.design_launches}
    if ops.launch_counts()["flash"] != cfg.n_layers * n_fwd or \
            kflash.design_launches != by_source:
        raise AssertionError(f"forward: {ops.launch_counts()} flash launches "
                             f"({kflash.design_launches} by source) in "
                             f"{n_fwd} forwards, want {cfg.n_layers} each, "
                             f"all on {source}")
    med = statistics.median(fwd_ms)
    print(f"forward B={B} S={S}: first {first_ms:.1f} ms, then "
          + ", ".join(f"{t:.1f}" for t in fwd_ms) + f" ms (median {med:.1f} "
          f"ms, {B * S / med * 1e3:.0f} tokens/s); aux {float(aux):.6f}; "
          f"peak device memory {peak / 1e9:.2f} GB; flash launches "
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
    agree = decode_agreement(torch.stack(dec, 1), par, f"decode vs forward "
                             f"at all {nb} x {s0} prompt positions")
    del par, dec
    n_extra = 0
    if cfg.n_experts:
        # a MoE's forward routes groups of router_group tokens and a
        # decode step its B tokens: at the published capacity the two
        # drop different tokens, in the reference as in the port
        # (tests/test_torch_moe.py); with the same weights at
        # capacity_factor E/k no group drops a token
        c2 = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
        par, _ = forward(model, c2, {"tokens": prompts})
        n_extra = 1
        caches = tserve.init_serve_cache(model, c2, nb, s0)
        dec = []
        for i in range(s0):
            lg, caches = tserve.serve_step(model, c2, caches,
                                           prompts[:, i:i + 1])
            dec.append(lg[:, 0])
        agree = decode_agreement(torch.stack(dec, 1), par,
                                 f"the same at capacity_factor "
                                 f"{c2.capacity_factor:.4f} (no drop)")
        del par, dec, caches
    if agree_min is not None and not agree > agree_min:
        raise AssertionError(f"decode vs forward: argmax agreement {agree} "
                             f"(want > {agree_min})")

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
    want = {**dict.fromkeys(counts, 0),
            "flash": cfg.n_layers * (n_fwd + 2 + n_extra), "flash_bwd": 0}
    if counts != want or kflash.design_launches[source] != want["flash"]:
        raise AssertionError(f"lm: launch counts {counts} "
                             f"({kflash.design_launches} by source), want "
                             f"{want}, all flash on {source}")
    print(f"lm path launches {counts} ({cfg.n_layers} per forward: {n_fwd} "
          "timed forwards, generate's prefill and the forward decode is "
          "held against; decode runs no flash kernel)")

    # where a forward and a decode step spend the card's time; the
    # Hopper design's instance of this model's widths must show there
    q0, _, v0, _ = captured[0]
    inst = f"flash_sm90_kernel<{q0.shape[3]}, {v0.shape[3]}>"
    sums = {"flash_bf16_kernel": 0.0, "flash_sm90_kernel<128, 128>": 0.0,
            "flash_sm90_kernel<192, 128>": 0.0}
    profile_once(lambda: forward(model, cfg, {"tokens": toks}),
                 f"one forward B={B} S={S}", sums)
    print(f"  flash kernels' device time in that forward: {sums}")
    if source == "flash_sm90" and not sums.get(inst, 0.0) > 0:
        raise AssertionError(f"lm profile: no device time of {inst}: {sums}")
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


DS_ARCH = "deepseek_v2_lite_16b"
# decode vs forward in fp32 at a capacity where no group drops a token
# (``phase_decode_fp32``): the same function up to fp32 summation order
# (the absorbed MLA against the decompressed one, about 1e-6 relative),
# so a row's argmax parts only where a router near-tie at that level
# sends a token to another expert; in bf16 the two forms round at other
# places, and ties within bf16's 2^-8 flip in some of 26 MoE layers
# (printed, not held: PERF.md section 6)
DS_FP32_AGREE = 0.99


def phase_flash_mla(gen):
    """The flash kernels at two widths (q and k 192 wide, v 128: MLA's
    prefill) against their plain version: bf16 on flash_sm90.cu's
    192/128 instance, fp32 on flash.cu's kernel; at DeepSeek-V2-Lite's
    prefill shape (4 x 4,096, 16 heads; the plain scores are 4.3 GB in
    fp32) and at ragged shapes (Sq and Sk not multiples of 64, H > KVH,
    an offset, a window), with the rows' lse; then, in turns within
    this call at the prefill shape, the kernel, the previous design
    (flash.cu's 192/128 bf16 kernel, launched by name), SDPA at the same
    two widths (or its refusal) and the plain version.  Returns the
    kernels-line entry without launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    log = ptxas_by_kernel(_build.build_log("flash"))
    for kernel, lines in log.items():
        print(f"  ptxas flash {kernel}: " + "; ".join(lines))
    two = [k for k in log if "flash_bf16_kernel" in k and "Li192E" in k]
    if len(two) != 1 or any(" 0 bytes spill stores" not in line
                            for line in log[two[0]] if "spill" in line):
        raise AssertionError(f"flash.cu's 192/128 bf16 kernel spills or is "
                             f"missing: {log}")
    # the Hopper design's instances; the 192/128 one neither spills nor
    # has its wgmma serialised for want of registers (ptxas's C7512)
    sm90_log = _build.build_log("flash_sm90")
    sm90 = ptxas_by_kernel(sm90_log)
    for kernel, lines in sm90.items():
        print(f"  ptxas flash_sm90 {kernel}: " + "; ".join(lines))
    mla = [k for k in sm90 if "flash_sm90_kernelILi192ELi128E" in k]
    serial = [line.strip() for line in sm90_log.splitlines()
              if "C7512" in line]
    for line in serial:
        print(f"  ptxas flash_sm90: {line}")
    if len(mla) != 1 or any(" 0 bytes spill stores" not in line
                            for line in sm90[mla[0]] if "spill" in line) \
            or any("Li192ELi128E" in line for line in serial):
        raise AssertionError(f"flash_sm90.cu's 192/128 kernel spills, is "
                             f"serialised (C7512) or is missing: {sm90}, "
                             f"{serial}")

    def rand(shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    B, S = LM_PREFILL
    H, dk, dv = 16, 192, 128
    errs = []
    cases = [(f"prefill b{B} s{S} h16 192/128", (B, S, H, dk), (B, S, H, dk),
              dv, dict(causal=True)),
             ("ragged sq130 sk257 h8/2 offset 100 window 96", (2, 130, 8, dk),
              (2, 257, 2, dk), dv, dict(causal=True, window=96,
                                       q_offset=100)),
             ("ragged sq77 sk333 h16/4 offset 256", (2, 77, 16, dk),
              (2, 333, 4, dk), dv, dict(causal=True, q_offset=256)),
             ("noncausal sq90 sk70 h6/3", (1, 90, 6, dk), (1, 70, 3, dk), dv,
              dict(causal=False))]
    for label, q_shape, k_shape, hdv, kw in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k = (rand(x, dt) for x in (q_shape, k_shape))
            v = rand(k_shape[:3] + (hdv,), dt)
            before = dict(kflash.design_launches)
            out, lse = kflash.flash_cuda(q, k, v, **kw, return_lse=True)
            again = kflash.flash_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            # bf16 on the Hopper design, fp32 on flash.cu
            src = "flash_sm90" if dt == torch.bfloat16 else "flash"
            if {n: c - before[n] for n, c in kflash.design_launches.items()} \
                    != {n: 2 * (n == src) for n in before}:
                raise AssertionError(f"flash two widths {label}: launched "
                                     f"{kflash.design_launches}, want two "
                                     f"on {src}")
            if not torch.equal(out, again):
                raise AssertionError(f"flash two widths {label}: out differs "
                                     "with and without lse")
            e = ref.check_attention(out, q, k, v, **kw,
                                    what=f"flash two widths {label}")
            el = ref.check_lse(lse, q, k, v, **kw)
            errs.append(e)
            print(f"  flash two widths {label} {str(dt)[6:]} on {src}: max "
                  f"abs err {e:.3e}, lse {el:.3e}")
            del q, k, v, out, lse, again
            torch.cuda.empty_cache()

    q_shape, k_shape = (B, S, H, dk), (B, S, H, dk)
    q, k = (rand(x, torch.bfloat16) for x in (q_shape, k_shape))
    v = rand((B, S, H, dv), torch.bfloat16)

    def sdpa2():
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)

    fns = {"flash_sm90 192/128": lambda: kflash.launch("flash_sm90", q, k,
                                                       v, causal=True),
           "flash.cu 192/128": lambda: kflash.launch("flash", q, k, v,
                                                     causal=True),
           "SDPA": sdpa2,
           "plain": lambda: ref.attention_ref(q, k, v, causal=True)}
    refusal = None
    try:
        got = sdpa2()
        torch.cuda.synchronize()
        ref.check_attention(got, q, k, v, causal=True, what="SDPA")
        del got
    except RuntimeError as exc:      # the yardstick alone, not the port
        refusal = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        print(f"  SDPA refuses q/k 192 against v 128: {refusal}")
        del fns["SDPA"]
    times = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            times[n].append(time_ms(fns[n], n=5 if n == "plain" else 20))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    b_ms, b_by, n_ops = flash_bound(q_shape, k_shape, dv)
    print(f"  flash two widths at the prefill shape b{B} s{S} h{H} {dk}/{dv} "
          f"bf16 causal, bound {b_ms:.3f} ms by {b_by} "
          f"({n_ops / 1e9:.1f} GFLOP); two rounds in turns, mean:")
    for n, t in times.items():
        print(f"    {n}: {ms[n]:.3f} ms ({', '.join(f'{x:.3f}' for x in t)})"
              f", {n_ops / ms[n] / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms[n]:.3f} of the bound")
    print(f"  flash_sm90 / flash.cu at 192/128 "
          f"{ms['flash_sm90 192/128'] / ms['flash.cu 192/128']:.3f}"
          + (f", flash_sm90 / SDPA "
             f"{ms['flash_sm90 192/128'] / ms['SDPA']:.3f}"
             if "SDPA" in ms else ""))
    del q, k, v
    torch.cuda.empty_cache()
    entry = {"name": "flash_two_widths", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_sm90.cu",
             "replaces": "src/repro/kernels/flash.py:129",
             "max_abs_err": max(errs), "ms": ms["flash_sm90 192/128"],
             "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": ms.get("SDPA"),
             "previous_ms": ms["flash.cu 192/128"],
             "previous_source": "src/repro_torch/kernels/csrc/flash.cu",
             "note": "bf16 on flash_sm90.cu's 192/128 instance; fp32 at "
                     "two widths (the fp32 decode check) on flash.cu"}
    if refusal:
        entry["library_note"] = f"SDPA refused: {refusal}"
    return entry


def phase_decode_fp32(seed: int):
    """DeepSeek-V2-Lite at full width and depth in fp32 (62.8 GB of
    weights from the seed), at capacity_factor E/k (no group drops a
    token): the decode path replayed over ``LM_GEN``'s prompts, held
    against the forward's logits (``DS_FP32_AGREE`` says why)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve as tserve
    from repro_torch.models import forward, init_model
    base = get_config(DS_ARCH)
    cfg = dataclasses.replace(base, dtype="float32", capacity_factor=(
        base.n_experts / base.top_k))
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory allocated before the fp32 model "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    nb, s0, _ = LM_GEN
    prompts = TokenStream(cfg.vocab_size, seed).batch(1, nb, s0)[:, :s0]
    par, _ = forward(model, cfg, {"tokens": prompts})
    caches = tserve.init_serve_cache(model, cfg, nb, s0)
    dec = []
    for i in range(s0):
        lg, caches = tserve.serve_step(model, cfg, caches,
                                       prompts[:, i:i + 1])
        dec.append(lg[:, 0])
    torch.cuda.synchronize()
    agree = decode_agreement(torch.stack(dec, 1), par,
                             f"fp32, capacity_factor "
                             f"{cfg.capacity_factor:.4f}, {nb} x {s0} "
                             "prompt positions")
    print(f"  fp32 model {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"peak; {time.perf_counter() - t0:.1f} s")
    if not agree > DS_FP32_AGREE:
        raise AssertionError(f"fp32 decode vs forward: argmax agreement "
                             f"{agree} (want > {DS_FP32_AGREE})")


TRAIN_ARCH = "smollm_135m"
TRAIN_SHAPE = (8, 4096)     # sequences x tokens a step: train_4k's length
TRAIN_STEPS = 30
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)
RESUME = (12, 4, 10)        # steps, save_every, the step a device is lost
BWD_QWEN = ((4, 4096, 32, 128), (4, 4096, 8, 128))   # Qwen3-4B prefill
# MLA's prefill at two widths (q/k 192, v 128): DeepSeek-V2-Lite's
# prefill shape (the two-width forward's row 4b) and the MLA train
# phase's, 2 x 4,096 tokens a step
MLA_V = 128
BWD_MLA = ((4, 4096, 16, 192), (4, 4096, 16, 192))
BWD_MLA_TRAIN = ((2, 4096, 16, 192), (2, 4096, 16, 192))
# n_micro=2 against n_micro=1, one step from one state on one batch:
# the loss, and each leaf's gradient as AdamW receives it, in the
# relative Frobenius norm |g2 - g1| / |g1|.  The microbatches' bf16
# products run at half the rows (cuBLAS may pick another kernel, another
# fp32 summation order, so bf16 outputs move by an ulp, 2^-8) and each
# microbatch's bf16 weight gradient is rounded apart before the fp32
# sum: three independent roundings of at most 2^-9 (rms 2^-9 / sqrt(3))
# against n_micro=1's one, about 2^-9 of a leaf's norm in quadrature.
# Loss rtol 1e-3 (the bf16 logits' 2^-9, averaged); gradients 2^-6, 8
# times the roundings' share, for the ulps that move activations and
# travel through 30 layers.  A fault (a microbatch lost or counted
# twice, a missing 1/n_micro) moves a leaf by 1/2 or more.  Read on an
# NVIDIA H100 80GB HBM3: at most 2.6e-3 over SmolLM-135M's 272 leaves
# (median 2.3e-3), the same as at smoke size on the CPU.
MICRO_TOL = dict(loss_rtol=1e-3, grad_rtol=2.0 ** -6)


def flash_bwd_bound(q_shape, kv_shape, hdv=None, causal=True):
    """(ms, by, operations) of one bf16 backward (causal from position 0
    unless ``causal`` is False), v ``hdv`` wide (default q's width): q,
    k, v, out, dout and lse read once, dq, dk, dv written once; five
    products per visible (query, key) pair and head, S, dK and dQ of 2
    hd operations and dP and dV of 2 hdv, at the tensor cores' bf16
    rate."""
    B, Sq, H, hd = q_shape
    Sk, KVH = kv_shape[1], kv_shape[2]
    hdv = hd if hdv is None else hdv
    pairs = visible_pairs(Sq, Sk, causal)
    n_bytes = 2 * (2 * B * Sq * H * (hd + hdv) + 2 * B * Sk * KVH
                   * (hd + hdv)) + 4 * B * H * Sq
    n_ops = 2 * (3 * hd + 2 * hdv) * B * H * pairs
    return bound(n_bytes, n_ops, PEAK_BF16_FLOPS) + (n_ops,)


def sdpa_bwd(q, k, v, dout, causal=True):
    """PyTorch's fused attention backward alone on the same inputs (the
    yardstick; v and dout may be narrower than q and k; causal from
    position 0, or without a mask): a function running
    torch.autograd.grad of one SDPA forward, kept for every call.
    Raises what SDPA raises on inputs it refuses."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                       enable_gqa=True)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                       retain_graph=True)


def device_kernels(fn, top: int = 3):
    """The names of the ``top`` kernels with the most device time in one
    call of fn (torch.profiler): which backend served a library call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # CPU and CUDA activities, as every profile of this script takes
    # them: after such a session, a CUDA-only one reported no kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ks.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return [e.key[:80] for e in ks[:top]]


# the one-width check of flash_bwd_sm90 (``one_width_sha256``): the
# flash_bwd probes it takes (bf16 at 64/64 and 128/128), ragged cases at
# hd 128 (an offset; a window from an offset, GQA 4; not causal) and
# the two path shapes
ONE_WIDTH_CASES = [
    ("causal GQA3 b2 s200 h9/3 hd64", (2, 200, 9, 64), (2, 200, 3, 64),
     dict(causal=True)),
    ("windowed offset GQA3 s100 vs 300 hd64", (1, 100, 6, 64),
     (1, 300, 2, 64), dict(causal=True, window=80, q_offset=200)),
    ("offset s77 vs 333 hd128", (1, 77, 4, 128), (1, 333, 4, 128),
     dict(causal=True, q_offset=256)),
    ("windowed offset GQA4 s130 vs 500 hd128", (2, 130, 8, 128),
     (2, 500, 2, 128), dict(causal=True, window=200, q_offset=370)),
    ("noncausal s64 vs 1000 hd128", (1, 64, 8, 128), (1, 1000, 2, 128),
     dict(causal=False)),
    ("train path", (8, 4096, 9, 64), (8, 4096, 3, 64), dict(causal=True)),
    ("qwen3_4b prefill", *BWD_QWEN, dict(causal=True))]
# sha256 of flash_bwd_sm90's (dq, dk, dv) at ONE_WIDTH_CASES as its
# one-width design (the source before it became a template on two
# widths) gave them on an NVIDIA H100 80GB HBM3 (700 W), torch
# 2.11.0+cu128: ``scripts_dev/flash_bwd_variants.py`` prints each
# variant's, the earlier source built from a copy beside the current one
ONE_WIDTH_SHA256 = {
    "causal GQA3 b2 s200 h9/3 hd64":
        "880036f300caba0ae6ad1e35fae6a18099495b677933857c200aafe7b3b1e3fa",
    "windowed offset GQA3 s100 vs 300 hd64":
        "3f7f7d0267b1ebbd971afadda2da35b46525f658e7509d74380c7a2d26aee5c4",
    "offset s77 vs 333 hd128":
        "27ddb365080f4552c5fbe247cbccb69108be0646b9ae4920560f861d577d75a4",
    "windowed offset GQA4 s130 vs 500 hd128":
        "d2378b221563fdf40154067e8c26b89d9e4dbed29a87928776ad3befb550b2ec",
    "noncausal s64 vs 1000 hd128":
        "e50f1429948936f07dcc4edf0ce303deeec3d51d84f737aae9ceccbb2a3a8e91",
    "train path":
        "779233ac1b2f38f4d8ddcc3aa695a0cd4b7e253efaed0f9e95a755543a33a3a6",
    "qwen3_4b prefill":
        "511afbb23c0c80634a286c12b2349d10d9b07018d5b70ce535edeb10c7652f75"}


def one_width_sha256(run):
    """{case: sha256 of dq, dk and dv} of ``run(q, k, v, out, lse, g,
    **kw)`` at ``ONE_WIDTH_CASES``, bf16 inputs from torch's CUDA
    generator seeded with the case's index, out and lse from the flash
    forward."""
    import torch
    from repro_torch.kernels import flash as kflash
    out = {}
    for i, (label, q_shape, kv_shape, kw) in enumerate(ONE_WIDTH_CASES):
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        q, k, v, g = (torch.randn(*s, device="cuda", generator=gen)
                      .to(torch.bfloat16)
                      for s in (q_shape, kv_shape, kv_shape, q_shape))
        o, lse = kflash.flash_cuda(q, k, v, **kw, return_lse=True)
        grads = run(q, k, v, o, lse, g, **kw)
        h = hashlib.sha256()
        for x in grads:
            h.update(x.contiguous().view(torch.int16).cpu().numpy()
                     .tobytes())
        out[label] = h.hexdigest()
        del q, k, v, g, o, lse, grads
    torch.cuda.empty_cache()
    return out


def phase_flash_bwd(gen):
    """The LSE forward (both designs' out bitwise without it, out and lse
    held against the plain version's) and the flash_bwd kernels against
    their plain version at the probes, at the training path's shape and
    at Qwen3-4B's prefill shape, each through the design that
    ``flash_bwd.design`` routes it to, two calls bitwise; at both path
    shapes the routed design (``flash_bwd_sm90``) also against the first
    design (``csrc/flash_bwd.cu``, launched uncounted through
    ``flash_bwd.launch``) within the same tolerance,
    and, in turns, the routed design, the first design, SDPA's backward
    and the plain version timed.  The one-width instances (64/64,
    128/128) give their one-width design's bits (``ONE_WIDTH_SHA256``).
    Then the two-width backward (MLA's prefill, q/k 192 against v 128)
    on ``flash_bwd_sm90``'s 192/128 instance (its ptxas lines printed: a
    spill or a wgmma serialised for want of registers, C7512, fails) at
    ragged probes and at both MLA path shapes (DeepSeek-V2-Lite's
    prefill and the MLA train phase's), held the same ways and timed in
    turns beside ``flash_bwd.cu``'s 192/128 kernel, SDPA's backward (its
    kernels named) and the plain version.  Returns (the kernels-line
    entry without launches, with the forward's errors under
    ``lse_max_abs_err`` and ``flash_max_abs_err``; the two-width
    entry without launches)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops, ref
    for name in ("flash_bwd_sm90", "flash_bwd"):
        kernels = ptxas_by_kernel(_build.build_log(name))
        for kernel, lines in kernels.items():
            print(f"  ptxas {name} {kernel}: " + "; ".join(lines))
    for line in _build.build_log("flash_bwd_sm90").splitlines():
        if "C75" in line:
            print(f"  ptxas flash_bwd_sm90: {line.strip()[:160]}")
    sm90 = ptxas_by_kernel(_build.build_log("flash_bwd_sm90"))
    spills = [k for k, lines in sm90.items() for line in lines
              if "spill" in line and " 0 bytes spill stores" not in line]
    if spills:
        raise AssertionError(f"flash_bwd_sm90 spills in {spills}")
    # the two-width instances: both of the 192/128 kernels there, none
    # with its wgmma serialised for want of registers
    two = [k for k in sm90 if k.endswith("<192, 128>")]
    serial = [line.strip() for line in _build.build_log(
        "flash_bwd_sm90").splitlines()
        if "C7512" in line and "Li192ELi128E" in line]
    for k in two:
        print(f"  ptxas flash_bwd_sm90 two widths {k}: "
              + "; ".join(sm90[k]))
    if sorted(two) != ["dkdv_kernel<192, 128>", "dq_kernel<192, 128>"] \
            or serial:
        raise AssertionError(f"flash_bwd_sm90's 192/128 kernels are "
                             f"missing or serialised (C7512): {two}, "
                             f"{serial}")
    # the one-width instances give the bits of the one-width design
    got = one_width_sha256(lambda *a, **kw: kbwd.launch(
        "flash_bwd_sm90", *a, **kw))
    differ = [k for k in got if got[k] != ONE_WIDTH_SHA256.get(k)]
    for k, h in got.items():
        print(f"  flash_bwd_sm90 one width {k}: sha256 {h[:16]}, "
              + ("the one-width design's bits" if k not in differ
                 else f"the one-width design's {ONE_WIDTH_SHA256.get(k)}"))
    if differ:
        raise AssertionError(f"flash_bwd_sm90's one-width instances differ "
                             f"from the one-width design at {differ}")
    print(f"flash_bwd tolerance: rtol {ref.FLASH_BWD_RTOL[torch.float32]} "
          f"(fp32), {ref.FLASH_BWD_RTOL[torch.bfloat16]} (bf16) of |plain| "
          f"+ sum |terms|; lse {ref.LSE_RTOL} (1 + |lse|) (kernels/ref.py "
          "states why)")

    def rand(shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    bf16 = torch.bfloat16
    B, S = TRAIN_SHAPE
    path = ((B, S, 9, 64), (B, S, 3, 64))
    probes = [(label, q, kv, dt, kw) for label, (q, kv, dt, kw)
              in ops.KERNELS["flash_bwd"].items()]
    # the LSE forward: out bitwise without lse on the design the wrapper
    # routes to, and on flash.cu for the bf16 probes at hd 64 and 128;
    # out and lse held against the plain version's
    errs, out_errs, lse_errs = [], [], []
    for label, q_shape, kv_shape, dt, kw in probes + [
            ("train path", *path, bf16, dict(causal=True))]:
        q, k, v = (rand(s, dt) for s in (q_shape, kv_shape, kv_shape))
        sources = [kflash.design(dt, q_shape[3])]
        if sources[0] == "flash_sm90":
            sources.append("flash")
        for src in sources:
            lse = torch.empty(q_shape[0], q_shape[2], q_shape[1],
                              device="cuda")
            out = kflash.launch(src, q, k, v, **kw, lse=lse)
            plain = kflash.launch(src, q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise AssertionError(f"lse forward {label} on {src}: out "
                                     "differs from the forward without lse")
            out_errs.append(ref.check_attention(out, q, k, v, **kw,
                                                what=f"out {label} {src}"))
            lse_errs.append(ref.check_lse(lse, q, k, v, **kw,
                                          what=f"lse {label} {src}"))
            print(f"  lse forward {label} {str(dt)[6:]} on {src}: out "
                  f"bitwise, out max abs err {out_errs[-1]:.3e}, lse max "
                  f"abs err {lse_errs[-1]:.3e}")
        del q, k, v
    # the backward against its plain version, twice bitwise, through the
    # design the wrapper routes to; at the path shapes and at two widths
    # (MLA's q/k 192 against v 128) the first design too, and the routed
    # design against it
    hdk, hdv = BWD_MLA[0][3], MLA_V
    two = [("two widths ragged sq130 sk257 h8/2 offset 100 window 96",
            (2, 130, 8, hdk), (2, 257, 2, hdk), hdv, bf16,
            dict(causal=True, window=96, q_offset=100)),
           ("two widths ragged sq77 sk333 h16/4 offset 256",
            (2, 77, 16, hdk), (2, 333, 4, hdk), hdv, bf16,
            dict(causal=True, q_offset=256)),
           ("two widths noncausal sq90 sk70 h6/3", (1, 90, 6, hdk),
            (1, 70, 3, hdk), hdv, bf16, dict(causal=False)),
           ("deepseek prefill", *BWD_MLA, hdv, bf16, dict(causal=True)),
           ("mla train", *BWD_MLA_TRAIN, hdv, bf16, dict(causal=True))]
    served, two_errs = set(), []
    for label, q_shape, kv_shape, w, dt, kw in [
            (lb, q, kv, q[3], dt, kw) for lb, q, kv, dt, kw in probes + [
                ("train path", *path, bf16, dict(causal=True)),
                ("qwen3_4b prefill", *BWD_QWEN, bf16,
                 dict(causal=True))]] + two:
        q, k, g = rand(q_shape, dt), rand(kv_shape, dt), \
            rand(q_shape[:3] + (w,), dt)
        v = rand(kv_shape[:3] + (w,), dt)
        out, lse = kflash.flash_cuda(q, k, v, **kw, return_lse=True)
        source = kbwd.design(dt, q_shape[3], w)
        before = kbwd.design_launches[source]
        grads = kbwd.flash_bwd_cuda(q, k, v, out, lse, g, **kw)
        again = kbwd.flash_bwd_cuda(q, k, v, out, lse, g, **kw)
        torch.cuda.synchronize()
        if kbwd.design_launches[source] != before + 2:
            raise AssertionError(f"flash_bwd {label}: not served by {source}")
        served.add(source)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash_bwd {label}: two calls differ")
        want = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
        mags = ref.attention_bwd_magnitude(q, k, v, out, lse, g, **kw)
        e = ref.check_bwd_close(grads, want, mags, dt,
                                what=f"flash_bwd {label} on {source}")
        (two_errs if w != q_shape[3] else errs).append(e)
        note = ""
        if label in ("train path", "qwen3_4b prefill") or w != q_shape[3]:
            prev = kbwd.launch("flash_bwd", q, k, v, out, lse, g, **kw)
            e1 = ref.check_bwd_close(prev, want, mags, dt,
                                     what=f"first design {label}")
            e2 = ref.check_bwd_close(grads, prev, mags, dt,
                                     what=f"{source} against the first "
                                     f"design {label}")
            note = (f"; {PREVIOUS_FLASH_BWD} max abs err {e1:.3e}, "
                    f"{source} against it {e2:.3e}")
            del prev
        print(f"  flash_bwd {label} {tuple(q_shape)}/{kv_shape[2]} "
              f"{q_shape[3]}/{w} {str(dt)[6:]} {kw} on {source}: max abs "
              f"err {e:.3e}, two calls bitwise{note}")
        del q, k, v, g, out, lse, grads, again, want, mags
        torch.cuda.empty_cache()
    print(f"flash_bwd served by {sorted(served)}")

    entry = mla = None
    for label, (q_shape, kv_shape), w in (
            ("train path", path, path[0][3]),
            ("qwen3_4b prefill", BWD_QWEN, BWD_QWEN[0][3]),
            ("deepseek prefill", BWD_MLA, hdv),
            ("mla train", BWD_MLA_TRAIN, hdv)):
        q, k, g = rand(q_shape, bf16), rand(kv_shape, bf16), \
            rand(q_shape[:3] + (w,), bf16)
        v = rand(kv_shape[:3] + (w,), bf16)
        out, lse = kflash.flash_cuda(q, k, v, causal=True, return_lse=True)
        source = kbwd.design(bf16, q_shape[3], w)
        fns = {source: lambda: kbwd.launch(source, q, k, v, out, lse, g,
                                           causal=True),
               "first design": lambda: kbwd.launch(
                   "flash_bwd", q, k, v, out, lse, g, causal=True),
               "plain": lambda: ref.attention_bwd_ref(q, k, v, out, lse, g,
                                                      causal=True)}
        library_note = None
        try:                 # the yardstick alone, not the port
            fns["SDPA backward"] = sdpa_bwd(q, k, v, g)
            library_note = (f"SDPA backward ran "
                            f"{device_kernels(fns['SDPA backward'], 2)}")
        except RuntimeError as exc:
            library_note = (f"SDPA refused: {type(exc).__name__}: "
                            f"{str(exc).splitlines()[0][:200]}")
            fns.pop("SDPA backward", None)
        times = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                times[n].append(time_ms(fns[n], n=5 if n == "plain"
                                        else 20))
        ms = {n: sum(t) / len(t) for n, t in times.items()}
        fwd_ms = time_ms(lambda: kflash.flash_cuda(q, k, v, causal=True,
                                                   return_lse=True))
        b_ms, b_by, n_ops = flash_bwd_bound(q_shape, kv_shape, w)
        print(f"  flash_bwd at {label} {q_shape}/{kv_shape[2]} "
              f"{q_shape[3]}/{w} bf16 causal, bound {b_ms:.3f} ms by {b_by} "
              f"({n_ops / 1e9:.1f} GFLOP); two rounds in turns, mean:")
        for n, t in times.items():
            print(f"    {n}: {ms[n]:.3f} ms ({', '.join(f'{x:.3f}' for x in t)}"
                  f"), {n_ops / ms[n] / 1e9:.1f} TFLOP/s, "
                  f"{b_ms / ms[n]:.3f} of the bound")
        print(f"    {library_note}; flash forward with lse at the same "
              f"shape: {fwd_ms:.3f} ms; {source} / first design "
              f"{ms[source] / ms['first design']:.3f}"
              + (f", {source} / SDPA backward "
                 f"{ms[source] / ms['SDPA backward']:.3f}"
                 if "SDPA backward" in ms else ""))
        shape = {"ms": ms[source], "plain_ms": ms["plain"],
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": ms.get("SDPA backward"),
                 "previous_ms": ms["first design"]}
        base = {"route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                "replaces": "src/repro/models/layers.py:245 (jnp "
                            "custom_vjp; no Pallas kernel)",
                "previous_source": PREVIOUS_FLASH_BWD}
        if label == "train path":
            entry = {"name": "flash_bwd", **base, "max_abs_err": max(errs),
                     **shape, "qwen3_4b_prefill": {}}
        elif label == "qwen3_4b prefill":
            entry["qwen3_4b_prefill"] = shape
        elif label == "deepseek prefill":
            mla = {"name": "flash_bwd_two_widths", **base,
                   "max_abs_err": max(two_errs), **shape,
                   "library_note": library_note,
                   "note": f"bf16 q/k {hdk} against v {hdv} (MLA's "
                           "prefill) on flash_bwd_sm90.cu's 192/128 "
                           "instance; ms at B=4 S=4,096 H=16"}
        else:
            mla["mla_train_shape"] = dict(shape, library_note=library_note)
        del q, k, v, g, out, lse, fns
        torch.cuda.empty_cache()
    entry["lse_max_abs_err"] = max(lse_errs)
    entry["flash_max_abs_err"] = max(out_errs)
    return entry, mla


def _clone_state(model, opt_state):
    import copy
    from repro_torch.optim import OptState
    return copy.deepcopy(model), OptState(
        {n: t.clone() for n, t in opt_state.m.items()},
        {n: t.clone() for n, t in opt_state.v.items()},
        opt_state.step.clone())


def _same_training_state(a, b, what):
    """Raise unless two (params, OptState) are the same bits."""
    import torch
    pa, pb = dict(a[0].named_parameters()), dict(b[0].named_parameters())
    diff = [n for n in pa if not torch.equal(pa[n], pb[n])]
    diff += [f"m[{n}]" for n in pa if not torch.equal(a[1].m[n], b[1].m[n])]
    diff += [f"v[{n}]" for n in pa if not torch.equal(a[1].v[n], b[1].v[n])]
    if diff or int(a[1].step) != int(b[1].step):
        raise AssertionError(f"{what}: {len(diff)} leaves differ (first "
                             f"{diff[:4]}), steps {int(a[1].step)} and "
                             f"{int(b[1].step)}")


def phase_train(seed: int, bwd_entry):
    """LM training at SmolLM-135M's full width and depth: 30 steps of 8 x
    4,096 tokens through ``repro_torch.launch.train.train``, its launch
    counts and its profile; one step twice from one state; resume and
    restart against an uninterrupted run; n_micro=2 against n_micro=1;
    ``generate`` on the trained model against its cast-once copy.
    Returns (flash_bwd entry with launches, flash launches of the run)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_lm_batch
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import for_serving, param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureSim

    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_SHAPE
    opt = AdamWConfig(**TRAIN_OPT)
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, "
          f"compute {cfg.dtype}; {param_count(cfg)[0]:,} parameters held as "
          f"fp32 masters; {TRAIN_STEPS} steps of {B} x {S} tokens, "
          f"AdamW {TRAIN_OPT}, remat on")

    # every step timed on the host clock between synchronisations, by
    # wrapping the module's make_train_step; beside each step, the
    # allocator's retries (a cudaFree of the cache after a failed
    # cudaMalloc) and the seconds in Python's garbage collector, so that
    # a slow step can be placed
    spans, retries, gc_ms = [], [], []
    in_gc = []
    orig = ttrain.make_train_step

    def on_gc(phase, info):
        if phase == "start":
            in_gc.append(time.perf_counter())
        elif in_gc:
            dt = (time.perf_counter() - in_gc.pop()) * 1e3
            if gc_ms:           # from a step's start to the next's
                gc_ms[-1] += dt

    def timed_make(*a, **kw):
        step = orig(*a, **kw)

        def timed(*x):
            torch.cuda.synchronize()
            r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            gc_ms.append(0.0)
            t = time.perf_counter()
            r = step(*x)
            torch.cuda.synchronize()
            spans.append((t, time.perf_counter()))
            retries.append(torch.cuda.memory_stats().get(
                "num_alloc_retries", 0) - r0)
            return r
        return timed

    # the earlier phases' garbage is collected here, not in a timed step
    # (a full collection of it takes seconds on the card's host)
    t = time.perf_counter()
    n = gc.collect()
    print(f"train: gc.collect() before the run: {n} unreachable objects in "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ttrain.make_train_step = timed_make
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        run = ttrain.train(cfg, steps=TRAIN_STEPS, batch=B, seq=S,
                           opt_cfg=opt, seed=seed, log_every=5)
        wall = time.perf_counter() - t0
    finally:
        ttrain.make_train_step = orig
        gc.callbacks.remove(on_gc)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.n_layers
    want = {**dict.fromkeys(counts, 0),
            "flash": 2 * n_layers * TRAIN_STEPS,
            "flash_bwd": n_layers * TRAIN_STEPS}
    if counts != want or kflash.design_launches["flash_sm90"] != \
            want["flash"] or kbwd.design_launches["flash_bwd_sm90"] != \
            want["flash_bwd"]:
        raise AssertionError(f"train: launch counts {counts} "
                             f"({kflash.design_launches}, "
                             f"{kbwd.design_launches} by source), want "
                             f"{want}, all flash on flash_sm90 and all "
                             "flash_bwd on flash_bwd_sm90")
    losses = run["losses"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"train: loss did not fall, {first} -> {last}")
    step_ms = [(e - t) * 1e3 for t, e in spans]
    med = statistics.median(step_ms[1:])
    # the window: steps 2 to the last, from the second step's start to
    # the last step's end, host work between steps included
    window_s = spans[-1][1] - spans[1][0]
    window_rate = (TRAIN_STEPS - 1) * B * S / window_s
    print(f"train: {TRAIN_STEPS} steps in {wall:.1f} s wall; step ms first "
          f"{step_ms[0]:.1f}, then median {med:.1f} (min "
          f"{min(step_ms[1:]):.1f}, max {max(step_ms[1:]):.1f}); "
          f"{B * S / med * 1e3:.0f} tokens/s at the median step, "
          f"{window_rate:.0f} tokens/s over steps 2-{TRAIN_STEPS} "
          f"({window_s * 1e3:.1f} ms wall, "
          f"{window_s * 1e3 - sum(step_ms[1:]):.1f} of it between steps); "
          "peak device memory "
          f"{peak / 1e9:.2f} GB")
    print("train: step ms " + " ".join(
        f"{i + 1}:{t:.1f}" + (f"[retries {r}]" if r else "")
        + (f"[gc {g:.1f}]" if g >= 0.1 else "")
        for i, (t, r, g) in enumerate(zip(step_ms, retries, gc_ms))))
    print(f"train: loss mean of the first five {first:.4f}, of the last five "
          f"{last:.4f}; losses " + " ".join(f"{x:.3f}" for x in losses))
    print(f"train: launches {counts} in {TRAIN_STEPS} steps: flash "
          f"{counts['flash'] // TRAIN_STEPS} a step (forward and the "
          f"checkpointed recompute of {n_layers} layers, all on flash_sm90), "
          f"flash_bwd {counts['flash_bwd'] // TRAIN_STEPS} a step (all on "
          "flash_bwd_sm90)")
    model, ost = run["params"], run["opt_state"]
    stream = TokenStream(cfg.vocab_size, seed=seed)
    t = time.perf_counter()
    batch = make_lm_batch(stream, TRAIN_STEPS, B, S)
    torch.cuda.synchronize()
    print(f"train: one step's batch from TokenStream (host) to the card in "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    step1 = ttrain.make_train_step(cfg, opt, n_micro=1)

    # one step twice from one state: the same bits?
    a = _clone_state(model, ost)
    b = _clone_state(model, ost)
    step1(*a, batch)
    step1(*b, batch)
    torch.cuda.synchronize()
    _same_training_state(a, b, "one step twice from one state")
    print("train: one step twice from one state gives the same bits "
          "(params, m, v, step)")
    del a, b

    # n_micro=2 against n_micro=1 on one batch from one state: the loss
    # and each leaf's gradient, as adamw_update receives it
    grads = []
    orig_update = ttrain.adamw_update

    def spy_update(opt_cfg, params, g, state):
        grads.append(g)
        return orig_update(opt_cfg, params, g, state)

    a = _clone_state(model, ost)
    b = _clone_state(model, ost)
    ttrain.adamw_update = spy_update
    try:
        _, _, m1 = step1(*a, batch)
        _, _, m2 = ttrain.make_train_step(cfg, opt, n_micro=2)(*b, batch)
    finally:
        ttrain.adamw_update = orig_update
    torch.cuda.synchronize()
    g1, g2 = grads
    rel = {n: float(torch.linalg.vector_norm(g2[n] - g1[n])
                    / torch.linalg.vector_norm(g1[n])) for n in g1}
    worst = sorted(rel, key=rel.get, reverse=True)
    dl = abs(float(m2["loss"]) - float(m1["loss"]))
    tol = MICRO_TOL
    print(f"train: n_micro=2 vs 1: loss {float(m2['loss']):.6f} vs "
          f"{float(m1['loss']):.6f} (|diff| {dl:.2e}), grad norm "
          f"{float(m2['grad_norm']):.6f} vs {float(m1['grad_norm']):.6f}; "
          f"each leaf's gradient, |g2 - g1| / |g1| (Frobenius): max "
          f"{rel[worst[0]]:.3e}, median "
          f"{statistics.median(rel.values()):.3e} over {len(rel)} leaves, "
          "the largest " + ", ".join(f"{n} {rel[n]:.3e}"
                                     for n in worst[:4])
          + f"; tolerance {tol}")
    if dl > tol["loss_rtol"] * abs(float(m1["loss"])) or \
            rel[worst[0]] > tol["grad_rtol"]:
        raise AssertionError("train: n_micro=2 is outside the stated "
                             "tolerance of n_micro=1")
    del a, b, grads, g1, g2

    # where a step spends the card's time
    prof = _clone_state(model, ost)
    bwd_ms = dict.fromkeys(("dkdv_kernel", "dq_kernel", "stats_kernel"))
    busy = profile_once(lambda: step1(*prof, batch),
                        f"one train step B={B} S={S}", sums=bwd_ms)
    print(f"train: flash_bwd's device time a step {sum(bwd_ms.values()):.1f} "
          f"ms (" + ", ".join(f"{k} {v:.1f}" for k, v in bwd_ms.items())
          + ")")
    # the profiler slows the host, not the kernels
    mean_step = window_s * 1e3 / (TRAIN_STEPS - 1)
    print(f"train: device busy {busy:.1f} ms against the median unprofiled "
          f"step of {med:.1f} ms: idle share {1 - busy / med:.3f}; against "
          f"the window's mean step of {mean_step:.1f} ms: "
          f"{1 - busy / mean_step:.3f}")
    del prof

    # generate on the trained fp32-master model against its cast-once copy
    prompts = stream.batch(TRAIN_STEPS + 1, 4, 64)[:, :64]
    got = tserve.generate(cfg, model, prompts, max_new=16)
    want_toks = tserve.generate(cfg, for_serving(model), prompts,
                                max_new=16)
    if not np.array_equal(got, want_toks):
        raise AssertionError("generate on the trained model differs from "
                             "its cast-once bf16 copy")
    print("train: generate on the trained fp32-master model (4 prompts of "
          "64 + 16 tokens) gives the tokens of its weights cast to bf16 "
          "once, bitwise")
    del run, model, ost
    torch.cuda.empty_cache()

    # resume and restart against an uninterrupted run
    steps, every, lost = RESUME
    ropt = AdamWConfig(**dict(TRAIN_OPT, total_steps=steps))
    whole = ttrain.train(cfg, steps=steps, batch=B, seq=S, opt_cfg=ropt,
                         seed=seed, log_every=0)
    whole_state = (whole["params"], whole["opt_state"])
    with tempfile.TemporaryDirectory() as d:
        sim = FailureSim(fail_at=[lost])
        cut = ttrain.train(cfg, steps=steps, batch=B, seq=S, opt_cfg=ropt,
                           seed=seed, log_every=0, ckpt_dir=d,
                           save_every=every, failure_sim=sim)
    if sim.failures != 1 or cut["final_step"] != steps:
        raise AssertionError(f"restart: {sim.failures} failures, final step "
                             f"{cut['final_step']}")
    _same_training_state((cut["params"], cut["opt_state"]), whole_state,
                         "restart after FailureSim")
    print(f"train: {steps} steps with a checkpoint every {every} and a lost "
          f"device at step {lost} (resumed from step "
          f"{lost // every * every}, {len(cut['losses'])} steps run) end on "
          "the uninterrupted run's bits (params, m, v, step)")
    del whole, whole_state, cut
    torch.cuda.empty_cache()
    bwd_entry["launches"] = counts["flash_bwd"]
    bwd_entry["launches_per_step"] = counts["flash_bwd"] // TRAIN_STEPS
    bwd_entry["train_device_ms_per_step"] = sum(bwd_ms.values())
    bwd_entry["train_step_ms"] = med
    bwd_entry["train_tokens_per_s"] = B * S / med * 1e3
    bwd_entry["train_window_tokens_per_s"] = window_rate
    bwd_entry["train_peak_gb"] = peak / 1e9
    return bwd_entry, counts["flash"]


# data-parallel training (the reference's make_sharded_train_step under
# "dponly"): SmolLM-135M at full width and depth, TRAIN_OPT, the train
# phase's global batch of TRAIN_SHAPE.  (a) NCCL ranks of device_count()
# for DP_NCCL_STEPS steps, each beside the single-process step; (b) two
# gloo ranks on the one card, each 4 x 4,096 rows, for DP_GLOO_STEPS
# steps, then train(variant="dponly") with a checkpoint every
# DP_RESTART[0] steps and a lost device at step DP_RESTART[1]
DP_NCCL_STEPS = 3
DP_GLOO_STEPS = 6
DP_RESTART = (3, 4)         # save_every, the step a device is lost
DP_FP32_TOL = dict(rtol=1e-4, atol=1e-5)   # test_torch_train.py's FP32_TOL
DP_CANCELLED = 2.0 ** -16                  # and its CANCELLED
# (b) against the single-process run: each step's global loss at
# test_torch_train_dp.py's bf16 loss rule, and the first all-reduced
# gradient (both from the same weights) by its relative norm: 3.6e-3 on
# an NVIDIA H100 80GB HBM3 (2.1e-3 at the smoke size on the CPU), where
# rank 1's rows dropped give 0.63 (and a loss 0.50 off)
DP_LOSS_RTOL = 1e-3
DP_GRAD_REL = 2e-2


def _dp_setup(world, seed):
    """(cfg, opt, step, plan, model, opt_state, stream) of a rank: the
    weights and the stream of ``seed``, as ``train`` draws them."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_SHAPE
    opt = AdamWConfig(**TRAIN_OPT)
    mesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("data",))
    step, plan = make_sharded_train_step(
        cfg, opt, mesh, ShapeSpec("train_dp", S, B, "train"),
        variant="dponly")
    model = init_model(cfg, seed, train=True)
    return cfg, opt, step, plan, model, step.init_opt_state(model), \
        TokenStream(cfg.vocab_size, seed=seed)


def _dp_batch(cfg, stream, i, step):
    from repro_torch.data import make_lm_batch
    from repro_torch.launch.specs import batch_shard
    B, S = TRAIN_SHAPE
    return batch_shard(make_lm_batch(stream, i, B, S), step.rank,
                       step.world_size, step.n_micro)


def _dp_launches(label, n_layers):
    """Raise unless the counts since the last reset are one step's: the
    forward and remat's recompute through flash_sm90, the backward
    through flash_bwd_sm90."""
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    want = {**dict.fromkeys(counts, 0), "flash": 2 * n_layers,
            "flash_bwd": n_layers}
    if counts != want or kflash.design_launches["flash_sm90"] != \
            want["flash"] or kbwd.design_launches["flash_bwd_sm90"] != \
            want["flash_bwd"]:
        raise AssertionError(f"{label}: launches {counts} "
                             f"({kflash.design_launches}, "
                             f"{kbwd.design_launches}), want {want} on "
                             "flash_sm90 / flash_bwd_sm90")
    return counts


def _dp_digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_dp_nccl_rank(rank, world, out, seed):
    """(a) ``DP_NCCL_STEPS`` sharded steps on NCCL ranks; at one rank
    each bitwise the single-process ``make_train_step`` on the same
    global batch from the same weights.  Rank 0 then carries the
    single-process run on to ``DP_GLOO_STEPS`` steps and writes its
    parameters and first gradients for (b)."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.data import make_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import adamw_init
    cfg, opt, step, plan, model, ost, stream = _dp_setup(world, seed)
    B, S = TRAIN_SHAPE
    single = copy.deepcopy(model)
    sost = adamw_init(dict(single.named_parameters()))
    single_step = ttrain.make_train_step(cfg, opt)
    first = []
    orig = ttrain.adamw_update

    def spy(opt_cfg, params, g, state):
        if not first:
            first.append({n: x.detach().cpu() for n, x in g.items()})
        return orig(opt_cfg, params, g, state)

    dp_ms, single_ms, single_losses, launches, peak = [], [], [], [], 0
    for i in range(DP_GLOO_STEPS):
        batch = make_lm_batch(stream, i, B, S)
        if i < DP_NCCL_STEPS:
            local = _dp_batch(cfg, stream, i, step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            model, ost, m = step(model, ost, local)
            torch.cuda.synchronize()
            dp_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(_dp_launches(f"dp train (a) step {i + 1}",
                                         cfg.n_layers))
            peak = max(peak, torch.cuda.max_memory_allocated())
            census = step.census()
        if rank != 0:
            continue
        ttrain.adamw_update = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single, sost, sm = single_step(single, sost, batch)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ttrain.adamw_update = orig
        single_losses.append(float(sm["loss"]))
        if i < DP_NCCL_STEPS and world == 1:
            named = dict(model.named_parameters())
            diff = [n for n, p in single.named_parameters()
                    if not torch.equal(p, named[n])
                    or not torch.equal(sost.m[n], ost.m[n])
                    or not torch.equal(sost.v[n], ost.v[n])]
            if diff or any(not torch.equal(m[k], sm[k])
                           for k in ("loss", "grad_norm", "lr")):
                raise AssertionError(
                    f"dp train (a) step {i + 1}: the NCCL world of one is "
                    f"not the single-process step's bits: {len(diff)} "
                    f"leaves differ ({diff[:3]}), loss {float(m['loss'])} "
                    f"against {float(sm['loss'])}")
    digests = [None] * world
    dist.all_gather_object(digests, _dp_digest(model))
    if len(set(digests)) != 1:
        raise AssertionError(f"dp train (a): ranks' parameters differ "
                             f"after {DP_NCCL_STEPS} steps")
    if rank == 0:
        torch.save({"params": {n: p.detach().cpu() for n, p in
                               single.named_parameters()},
                    "first_grad": first[0], "losses": single_losses},
                   Path(out) / "dp_single.pt")
        # where a step's time goes, beside the single-process step's
        busy = profile_once(lambda: step(model, ost, local),
                            f"one dp step (a), world {world}, B={B} S={S}")
        busy_single = profile_once(lambda: single_step(single, sost, batch),
                                   f"one single-process step B={B} S={S}")
        (Path(out) / "dp_nccl.json").write_text(json.dumps({
            "world": world, "dp_ms": dp_ms, "single_ms": single_ms,
            "peak": peak, "census": census, "launches": launches,
            "busy": busy, "busy_single": busy_single}))


def _dp_loss_rel(loss, want: float) -> float:
    """|loss - want| / |want|: a sharded step's global loss against the
    single-process step's."""
    return abs(float(loss) - want) / abs(want)


def _dp_grad_rel(grads, want) -> float:
    """||g - want|| / ||want|| over every leaf, the sums in fp64: a
    sharded step's all-reduced gradient against the single-process
    step's from the same weights."""
    import torch
    num = den = 0.0
    for n, g in grads.items():
        w = want[n].to(g.device, torch.float64)
        num += float(torch.sum((g.to(torch.float64) - w) ** 2))
        den += float(torch.sum(w * w))
    return (num / den) ** 0.5


def train_dp_gloo_rank(rank, world, out, seed):
    """(b) ``DP_GLOO_STEPS`` sharded steps on gloo ranks sharing the one
    card: after every step the ranks' parameters bitwise equal and each
    rank's ZeRO-1 result bitwise an unsharded ``adamw_update`` of a copy
    fed the same all-reduced gradients; rank 0 holds every step's global
    loss and the first all-reduced gradient against the single-process
    run of (a), after showing that these checks refuse a planted fault
    (rank 1's rows dropped before the flat all-reduce), and the last
    step's parameters within 2 lr x steps of it; a checkpoint's moment
    gather is bitwise the unsharded moments, and its device bytes are
    measured; then ``train(variant="dponly")`` with a checkpoint every
    ``DP_RESTART[0]`` steps and a lost device at ``DP_RESTART[1]`` ends
    on the uninterrupted run's bits."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime import FailureSim
    cfg, opt, step, plan, model, ost, stream = _dp_setup(world, seed)
    plain = {n: p.detach().clone() for n, p in model.named_parameters()}
    pst = adamw_init(plain)
    ms, comm_ms, losses, census = [], [], [], None
    step_counts, loss_rel, grad_rel = [], [], None
    ref = torch.load(Path(out) / "dp_single.pt") if rank == 0 else None

    # the control: from the same weights and batch, rank 1's rows dropped
    # before the flat all-reduce (its weight forced to 0)
    flat_reduce = step._all_reduce

    def dropped(t):
        if rank == 1 and t.numel() > step.n_micro:   # not the label counts
            t.zero_()
        return flat_reduce(t)

    step._all_reduce = dropped
    try:
        c_loss, c_grads = step.gradients(model, _dp_batch(cfg, stream, 0,
                                                          step))
    finally:
        step._all_reduce = flat_reduce
    control = None
    if rank == 0:
        control = (_dp_loss_rel(c_loss, ref["losses"][0]),
                   _dp_grad_rel(c_grads, ref["first_grad"]))
        if control[0] <= DP_LOSS_RTOL or control[1] <= DP_GRAD_REL:
            raise AssertionError(
                "dp train (b): a check against the single-process run "
                "passes the planted fault (rank 1's rows dropped): loss "
                f"{control[0]:.3e} (limit {DP_LOSS_RTOL}), gradient "
                f"{control[1]:.3e} (limit {DP_GRAD_REL})")
    del c_loss, c_grads

    def timed(collective):
        # the host clock around each of the step's collectives, between
        # synchronisations: gloo's copies through the host included
        def run(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = collective(t)
            torch.cuda.synchronize()
            comm_ms[-1] += (time.perf_counter() - t0) * 1e3
            return r
        return run

    step._all_reduce = timed(step._all_reduce)
    step._all_gather = timed(step._all_gather)
    torch.cuda.reset_peak_memory_stats()
    for i in range(DP_GLOO_STEPS):
        local = _dp_batch(cfg, stream, i, step)
        step.reset_census()
        comm_ms.append(0.0)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step.gradients(model, local)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, pst, _ = adamw_update(opt, plain, grads, pst)
        if rank == 0:
            loss_rel.append(_dp_loss_rel(loss, ref["losses"][i]))
            if i == 0:
                grad_rel = _dp_grad_rel(grads, ref["first_grad"])
            if loss_rel[-1] > DP_LOSS_RTOL or grad_rel > DP_GRAD_REL:
                raise AssertionError(
                    f"dp train (b) step {i + 1}: against the "
                    f"single-process run, loss {float(loss)} for "
                    f"{ref['losses'][i]} (rel {loss_rel[-1]:.3e}, limit "
                    f"{DP_LOSS_RTOL}), first gradient rel {grad_rel:.3e} "
                    f"(limit {DP_GRAD_REL})")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        model, ost, m = step.apply(model, ost, grads)
        torch.cuda.synchronize()
        ms.append((t1 - t0 + time.perf_counter() - t2) * 1e3)
        del grads
        step_counts.append(_dp_launches(
            f"dp train (b) rank {rank} step {i + 1}", cfg.n_layers))
        census = step.census()
        losses.append(float(loss))
        named = dict(model.named_parameters())
        diff = [n for n in plan.shapes
                if not torch.equal(named[n], plain[n])
                or not torch.equal(ost.m[n], plan.shard(n, pst.m[n], rank))
                or not torch.equal(ost.v[n], plan.shard(n, pst.v[n], rank))]
        if diff:
            raise AssertionError(
                f"dp train (b) rank {rank} step {i + 1}: ZeRO-1 is not the "
                f"unsharded update's bits at {len(diff)} leaves "
                f"({diff[:3]})")
        digests = [None] * world
        dist.all_gather_object(digests, _dp_digest(model))
        if len(set(digests)) != 1:
            raise AssertionError(f"dp train (b) step {i + 1}: the ranks' "
                                 "parameters differ")
    peak = torch.cuda.max_memory_allocated()
    del step._all_reduce, step._all_gather      # the untimed collectives

    # a checkpoint's gather of the moments to rank 0's host: the device
    # bytes it adds to a rank, and its bits against the unsharded moments
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full = step.host_opt_state(ost)
    save_extra = torch.cuda.max_memory_allocated() - before
    if full is not None and any(
            not torch.equal(full.m[n], pst.m[n].cpu())
            or not torch.equal(full.v[n], pst.v[n].cpu())
            for n in plan.shapes):
        raise AssertionError("dp train (b): the checkpoint's gathered "
                             "moments are not the unsharded moments")
    del plain, pst, full
    torch.cuda.empty_cache()
    held = None
    if rank == 0:
        worst, outside, cancelled, n = 0.0, 0, 0, 0
        for name, p in model.named_parameters():
            got = p.detach().cpu().numpy()
            want = ref["params"][name].numpy()
            g0 = ref["first_grad"][name].abs().numpy()
            d = np.abs(got - want)
            worst = max(worst, float(d.max()))
            bad = ~np.isclose(got, want, **DP_FP32_TOL)
            canc = g0 <= DP_CANCELLED * g0.max()
            outside += int((bad & ~canc).sum())
            cancelled += int((bad & canc).sum())
            n += got.size
        bound = 2 * TRAIN_OPT["lr"] * DP_GLOO_STEPS
        held = {"max_abs_diff": worst, "bf16_bound": bound,
                "fp32_outside": outside, "fp32_cancelled": cancelled,
                "elements": n, "loss_rel": loss_rel, "grad_rel": grad_rel,
                "control_loss_rel": control[0],
                "control_grad_rel": control[1]}
        if worst > bound:
            raise AssertionError(
                f"dp train (b): parameters after {DP_GLOO_STEPS} steps "
                f"{worst} from the single-process run's, above 2 lr x "
                f"steps = {bound}")
        del ref

    # the restart: train() itself, from the same weights and stream
    every, lost = DP_RESTART
    sim = FailureSim(fail_at=[lost])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cut = ttrain.train(cfg, steps=DP_GLOO_STEPS, batch=TRAIN_SHAPE[0],
                       seq=TRAIN_SHAPE[1], opt_cfg=AdamWConfig(**TRAIN_OPT),
                       seed=seed, log_every=0,
                       ckpt_dir=str(Path(out) / "dp_ckpt"),
                       save_every=every, failure_sim=sim, variant="dponly")
    restart_s = time.perf_counter() - t0
    run = lost + DP_GLOO_STEPS - lost // every * every
    restart_counts = ops.launch_counts()
    want_losses = losses[:lost] + losses[lost // every * every:]
    cn = dict(cut["params"].named_parameters())
    diff = [n for n, p in model.named_parameters()
            if not torch.equal(cn[n], p)
            or not torch.equal(cut["opt_state"].m[n], ost.m[n])
            or not torch.equal(cut["opt_state"].v[n], ost.v[n])]
    if sim.failures != 1 or cut["losses"] != want_losses or diff \
            or restart_counts["flash"] != 2 * run * cfg.n_layers \
            or restart_counts["flash_bwd"] != run * cfg.n_layers:
        raise AssertionError(
            f"dp train (b) rank {rank}: the restart ({sim.failures} "
            f"failures, {len(cut['losses'])} steps, {len(diff)} leaves "
            f"differ, launches {restart_counts}) is not the uninterrupted "
            "run")
    (Path(out) / f"dp_gloo{rank}.json").write_text(json.dumps({
        "ms": ms, "comm_ms": comm_ms, "losses": losses, "peak": peak,
        "census": census, "save_extra": save_extra,
        "save_chunk": ttrain._SAVE_CHUNK,
        "launches": step_counts, "held": held, "restart_s": restart_s,
        "restart_steps": run, "moment_bytes": plan.moment_bytes(),
        "full_moment_bytes": plan.full_moment_bytes()}))


def phase_train_dp(seed: int):
    """Data-parallel training through ``make_sharded_train_step(variant=
    "dponly")`` at SmolLM-135M's full width and depth, with ``TRAIN_OPT``
    and a global batch of ``TRAIN_SHAPE``: (a) a world of
    ``torch.cuda.device_count()`` NCCL ranks, ``DP_NCCL_STEPS`` steps, at
    one rank bitwise the single-process step; (b) two gloo ranks on the
    one card (``TRAIN_SHAPE[0] // 2`` sequences each), ``DP_GLOO_STEPS``
    steps: ranks bitwise equal, ZeRO-1 bitwise the unsharded update,
    the losses, the first gradient and the parameters against the
    single-process run (the first two shown to refuse a planted fault),
    flash and flash_bwd 2 x 30 and 30 launches a step on each rank, a
    checkpoint's moment gather bitwise, a checkpointed restart bitwise.
    Returns (flash launches, flash_bwd launches) by run and rank."""
    import tempfile
    import torch
    from repro_torch.runtime import run_world
    n = torch.cuda.device_count()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = run_world("chip_smoke:train_dp_nccl_rank", n,
                         device_type="cuda", workdir=Path(tmp) / "nccl",
                         args=(tmp, seed), extra_paths=[str(ROOT)],
                         timeout_s=600)
        print(outs[0], end="")
        a = json.loads((Path(tmp) / "dp_nccl.json").read_text())
        c = a["census"]
        print(f"dp train (a): world of {n} NCCL rank(s), "
              f"{DP_NCCL_STEPS} steps of {TRAIN_SHAPE[0]} x "
              f"{TRAIN_SHAPE[1]} tokens"
              + (", each bitwise the single-process step (params, m, v, "
                 "loss, grad norm, lr)" if n == 1 else "")
              + "; step ms " + " ".join(f"{t:.1f}" for t in a["dp_ms"])
              + " against the single-process step's "
              + " ".join(f"{t:.1f}" for t in a["single_ms"][:DP_NCCL_STEPS])
              + f"; peak {a['peak'] / 1e9:.2f} GB; a step's collectives: "
              f"{c['all_reduces']} all-reduces ({c['reduce_elems']:,} "
              f"elements), {c['all_gathers']} all-gather "
              f"({c['gather_elems']:,} elements sent), "
              f"{c['wire_bytes']:,} bytes sent by a rank, {c['dtypes']}; "
              f"device busy a profiled step {a['busy']:.1f} ms (the "
              f"single-process step's {a['busy_single']:.1f}); "
              f"{time.perf_counter() - t0:.1f} s with the ranks' start "
              f"and {DP_GLOO_STEPS} single-process steps for (b)")
        t0 = time.perf_counter()
        run_world("chip_smoke:train_dp_gloo_rank", 2, device_type="cuda",
                  backend="gloo", local_ranks=[0, 0],
                  workdir=Path(tmp) / "gloo", args=(tmp, seed),
                  extra_paths=[str(ROOT)], timeout_s=900)
        b = [json.loads((Path(tmp) / f"dp_gloo{r}.json").read_text())
             for r in range(2)]
    h, c = b[0]["held"], b[0]["census"]
    med = [statistics.median(r["ms"][1:]) for r in b]
    print(f"dp train (b): 2 gloo ranks on one card, {TRAIN_SHAPE[0] // 2} x "
          f"{TRAIN_SHAPE[1]} tokens each, {DP_GLOO_STEPS} steps: ranks "
          "bitwise equal after every step, ZeRO-1 bitwise the unsharded "
          "adamw_update of the same all-reduced gradients; step ms rank 0 "
          + " ".join(f"{t:.1f}" for t in b[0]["ms"]) + ", rank 1 "
          + " ".join(f"{t:.1f}" for t in b[1]["ms"])
          + f" (medians after the first {med[0]:.1f}, {med[1]:.1f}; of "
          "which in the collectives, host clock around each: rank 0 "
          + " ".join(f"{t:.1f}" for t in b[0]["comm_ms"]) + "); peak "
          f"{b[0]['peak'] / 1e9:.2f} and {b[1]['peak'] / 1e9:.2f} GB; "
          f"moments {b[0]['moment_bytes'] / 1e9:.3f} GB a rank of "
          f"{b[0]['full_moment_bytes'] / 1e9:.3f}; a step's collectives: "
          f"{c['all_reduces']} all-reduces ({c['reduce_elems']:,} "
          f"elements), {c['all_gathers']} all-gather "
          f"({c['gather_elems']:,} elements sent), {c['wire_bytes']:,} "
          f"bytes sent by a rank, {c['dtypes']}; losses "
          + " ".join(f"{x:.4f}" for x in b[0]["losses"]))
    print(f"dp train (b): against the single-process run: each step's "
          "global loss rel diff " + " ".join(f"{x:.3e}" for x in
                                             h["loss_rel"])
          + f" (limit {DP_LOSS_RTOL}), the first all-reduced gradient's "
          f"relative norm diff {h['grad_rel']:.3e} (limit {DP_GRAD_REL}); "
          "the planted fault (rank 1's rows dropped before the flat "
          f"all-reduce) refused by both: loss {h['control_loss_rel']:.3e}, "
          f"gradient {h['control_grad_rel']:.3e}")
    print(f"dp train (b): parameters after {DP_GLOO_STEPS} steps: max "
          f"|diff| {h['max_abs_diff']:.3e} (held within 2 lr x steps = "
          f"{h['bf16_bound']:.1e}, test_torch_train.py's rule for bf16, "
          "the config's compute dtype); outside "
          f"FP32_TOL {h['fp32_outside']:,} of {h['elements']:,} elements "
          f"besides {h['fp32_cancelled']:,} cancelled ones (first gradient "
          f"below 2^-16 of its leaf's largest)")
    print(f"dp train (b): a checkpoint's gather of the moments to rank 0's "
          "host bitwise the unsharded moments, adding "
          f"{b[0]['save_extra'] / 1e6:.1f} and "
          f"{b[1]['save_extra'] / 1e6:.1f} MB to the ranks' device memory "
          f"(chunks of {b[0]['save_chunk']:,} elements)")
    print(f"dp train (b): train(variant='dponly') with a checkpoint every "
          f"{DP_RESTART[0]} steps and a lost device at step {DP_RESTART[1]}"
          f" ({b[0]['restart_steps']} steps run) ends on the uninterrupted "
          f"run's bits on both ranks, {b[0]['restart_s']:.1f} s; "
          f"(b) {time.perf_counter() - t0:.1f} s with the ranks' start")
    print(f"dp train: phase {time.perf_counter() - t_phase:.1f} s")
    launches = {}
    for k in ("flash", "flash_bwd"):
        launches[k] = {
            "nccl_rank0": sum(x[k] for x in a["launches"]),
            "nccl_steps": DP_NCCL_STEPS,
            "gloo_ranks": [sum(x[k] for x in r["launches"]) for r in b],
            "gloo_steps": DP_GLOO_STEPS,
            "per_step_per_rank": a["launches"][0][k]}
    return (launches["flash"], launches["flash_bwd"],
            {"step_ms_gloo": med, "step_ms_nccl": a["dp_ms"],
             "single_ms": a["single_ms"], "peak_gb": [r["peak"] / 1e9
                                                      for r in b]})


# MLA training: DeepSeek-V2-Lite at full width, its depth cut to the
# dense prologue layer and two MLA+MoE layers (1,670,131,712 parameters,
# 26.72 GB at 16 bytes each: fp32 master, gradient, two moments); 10
# AdamW steps of 2 x 4,096 tokens (eight router groups of 1,024), remat
# on.  Four layers (2,254,979,072 parameters, 36.08 GB) ran out of the
# card's 80 GB in AdamW's update, whose foreach passes hold about six
# more fp32 copies of the parameters (on an NVIDIA H100 80GB HBM3)
MLA_TRAIN_LAYERS = 3
MLA_TRAIN_STEPS = 10
MLA_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=MLA_TRAIN_STEPS)


def state_fingerprint(model, opt_state):
    """Two int64 sums of the bit patterns of every parameter and moment,
    one weighted by an odd number a position (so a changed element
    always moves it), on the card: the same state gives the same
    fingerprint, and a state that differs in any bit differs in it but
    by a coincidence of sums."""
    import torch
    chunk = 1 << 26
    w = torch.arange(chunk, dtype=torch.int64, device="cuda") * 2 + 1
    s1 = torch.zeros((), dtype=torch.int64, device="cuda")
    s2 = torch.zeros((), dtype=torch.int64, device="cuda")
    named = dict(model.named_parameters())
    for leaf in [named[n] for n in named] + [opt_state.m[n] for n in named] \
            + [opt_state.v[n] for n in named]:
        flat = leaf.detach().reshape(-1).view(torch.int32)
        for i in range(0, flat.numel(), chunk):
            c = flat[i:i + chunk].to(torch.int64)
            s1 += c.sum()
            s2 += (c * w[:c.numel()]).sum()
    return int(s1), int(s2), int(opt_state.step)


def phase_train_mla(seed: int, entry):
    """MLA training (``MLA_TRAIN_*``): DeepSeek-V2-Lite at its published
    width through ``repro_torch.launch.train.train``, random fp32 masters
    from ``seed``: the loss finite every step and falling, flash_bwd
    launched once a layer a step, all on ``flash_bwd_sm90`` (its 192/128
    instance), flash once a layer and once more a stacked layer
    (remat's recompute) a step, all on ``flash_sm90``; step ms, tokens/s,
    the peak; one step run twice from one state (the model drawn again
    from the seed) the same bits; a profiled step's busy time, idle
    share and device time by kernel and by operation, flash_bwd's beside
    MoE routing's.  Returns the two-width entry with its launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_lm_batch
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import init_model, moe, param_count
    from repro_torch.models import transformer
    from repro_torch.optim import AdamWConfig, adamw_init

    full = get_config(DS_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_TRAIN_LAYERS)
    (B, S), steps = BWD_MLA_TRAIN[0][:2], MLA_TRAIN_STEPS
    opt = AdamWConfig(**MLA_TRAIN_OPT)
    n_par, n_full = param_count(cfg)[0], param_count(full)[0]
    print(f"model {cfg.name} at full width: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA kv_lora {cfg.kv_lora_rank}, nope "
          f"{cfg.qk_nope_dim}, rope {cfg.qk_rope_dim}, v {cfg.v_head_dim}; "
          f"{cfg.n_experts} routed experts top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared (d_ff_expert {cfg.d_ff_expert}), "
          f"router groups of {cfg.router_group}, vocab {cfg.vocab_size}; "
          f"depth cut from {full.n_layers} to {cfg.n_layers} layers (the "
          f"dense prologue layer and {len(cfg.pattern) * cfg.repeats} "
          f"MLA+MoE layers): {n_par:,} parameters, "
          f"{16 * n_par / 1e9:.2f} GB as fp32 masters, gradients and two "
          f"moments (16 bytes a parameter); the uncut {n_full:,} would "
          f"need {16 * n_full / 1e9:.0f} GB, more than the card's 80; "
          f"{steps} steps of {B} x {S} tokens, AdamW {MLA_TRAIN_OPT}, "
          "remat on")
    spans = []
    orig = ttrain.make_train_step

    def timed_make(*a, **kw):
        step = orig(*a, **kw)

        def timed(*x):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step(*x)
            torch.cuda.synchronize()
            spans.append((t, time.perf_counter()))
            return r
        return timed

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ttrain.make_train_step = timed_make
    try:
        t0 = time.perf_counter()
        run = ttrain.train(cfg, steps=steps, batch=B, seq=S, opt_cfg=opt,
                           seed=seed, log_every=0)
        wall = time.perf_counter() - t0
    finally:
        ttrain.make_train_step = orig
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_stack = len(run["params"].stack)
    want = {**dict.fromkeys(counts, 0),
            "flash": (cfg.n_layers + n_stack) * steps,
            "flash_bwd": cfg.n_layers * steps}
    if counts != want or kflash.design_launches["flash_sm90"] != \
            want["flash"] or kbwd.design_launches["flash_bwd_sm90"] != \
            want["flash_bwd"]:
        raise AssertionError(f"train mla: launch counts {counts} "
                             f"({kflash.design_launches}, "
                             f"{kbwd.design_launches} by source), want "
                             f"{want}, all flash on flash_sm90 and all "
                             "flash_bwd on flash_bwd_sm90")
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train mla: losses {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"train mla: loss did not fall, {first} -> "
                             f"{last}")
    step_ms = [(e - t) * 1e3 for t, e in spans]
    med = statistics.median(step_ms[1:])
    print(f"train mla: {steps} steps in {wall:.1f} s wall; step ms "
          + " ".join(f"{i + 1}:{t:.1f}" for i, t in enumerate(step_ms))
          + f"; median after the first {med:.1f}, {B * S / med * 1e3:.0f} "
          f"tokens/s; peak device memory {peak / 1e9:.2f} GB")
    print(f"train mla: loss mean of the first three {first:.4f}, of the last "
          f"three {last:.4f}; losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train mla: launches {counts} in {steps} steps: flash_bwd "
          f"{counts['flash_bwd'] // steps} a step (one a layer, all on "
          f"flash_bwd_sm90's 192/128 instance), flash "
          f"{counts['flash'] // steps} a step ({cfg.n_layers} layers and "
          f"the recompute of the {n_stack} checkpointed ones, all on "
          "flash_sm90)")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # one step twice from one state: the model drawn again from the seed
    batch = make_lm_batch(TokenStream(cfg.vocab_size, seed=seed), steps, B,
                          S)
    step1 = ttrain.make_train_step(cfg, opt)
    prints = []
    for _ in range(2):
        model = init_model(cfg, seed, device="cuda", train=True)
        ost = adamw_init(dict(model.named_parameters()))
        before = state_fingerprint(model, ost)
        model, ost, met = step1(model, ost, batch)
        torch.cuda.synchronize()
        prints.append((before, state_fingerprint(model, ost),
                       float(met["loss"])))
        if len(prints) == 1:
            del model, ost
            gc.collect()
            torch.cuda.empty_cache()
    if prints[0] != prints[1]:
        raise AssertionError(f"train mla: one step twice from one state "
                             f"differs: {prints}")
    print(f"train mla: one step twice from one state (drawn again from "
          f"the seed) gives the same bits: loss {prints[0][2]:.6f}, state "
          f"fingerprint {prints[0][1][:2]} (params, m, v)")

    # where a step spends the card's time: flash_bwd's kernels beside
    # MoE routing's (moe.route's device time, forward and remat's
    # recompute; apply_moe's whole, experts included)
    saved = moe.route, transformer.apply_moe

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    moe.route = ranged("moe.route", saved[0])
    transformer.apply_moe = ranged("moe.apply_moe", saved[1])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step1(model, ost, batch)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
    finally:
        moe.route, transformer.apply_moe = saved
    # the ranges' own spans on the device timeline are not kernels
    busy = busy_ms([e for e in prof.events()
                    if not e.name.startswith("moe.")])
    if not 0 < busy <= pwall:
        raise AssertionError(f"train mla profile: busy {busy} of {pwall} ms")
    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA
               and not e.key.startswith("moe.")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile, one train step: {pwall:.1f} ms wall (profiler on), "
          f"device busy {busy:.1f} ms, idle share {1 - busy / pwall:.3f} "
          f"with the profiler on, {1 - busy / med:.3f} against the median "
          f"unprofiled step ({med:.1f} ms); by kernel:")
    for e in kernels[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    print("  by operation (device time of the kernels each launched; moe.* "
          "cover the forward and the recompute, not the backward):")
    opsl = [e for e in stats if e.device_type != DeviceType.CUDA
            and (e.key.startswith(("aten::", "moe.", "autograd::engine")))
            and e.device_time_total > 0]
    opsl.sort(key=lambda e: e.device_time_total, reverse=True)
    for e in opsl[:12]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    part = {k: sum(e.self_device_time_total for e in kernels
                   if k in e.key) / 1e3
            for k in ("dkdv_kernel", "dq_kernel", "stats_kernel",
                      "flash_sm90_kernel")}
    rng = {k: sum(e.device_time_total for e in stats if e.key == k
                  and e.device_type != DeviceType.CUDA) / 1e3
           for k in ("moe.route", "moe.apply_moe")}
    bwd_ms = part["dkdv_kernel"] + part["dq_kernel"] + part["stats_kernel"]
    print(f"train mla: flash_bwd's device time a step {bwd_ms:.1f} ms "
          f"({bwd_ms / busy:.3f} of busy; dkdv {part['dkdv_kernel']:.1f}, dq "
          f"{part['dq_kernel']:.1f}, stats {part['stats_kernel']:.1f}), the "
          f"flash forward {part['flash_sm90_kernel']:.1f} ms; MoE routing "
          f"(moe.route) {rng['moe.route']:.1f} ms "
          f"({rng['moe.route'] / busy:.3f} of busy), the MoE layers' "
          f"forward and recompute whole {rng['moe.apply_moe']:.1f} ms")
    del model, ost, prof, stats
    gc.collect()
    torch.cuda.empty_cache()
    entry["launches"] = counts["flash_bwd"]
    entry["launches_per_step"] = counts["flash_bwd"] // steps
    entry["train_device_ms_per_step"] = bwd_ms
    entry["train_step_ms"] = med
    entry["train_tokens_per_s"] = B * S / med * 1e3
    entry["train_peak_gb"] = peak / 1e9
    entry["train_layers"] = cfg.n_layers
    return entry


# the SSM family: Mamba2-130M uncut (configs/mamba2_130m.py), served and
# trained; Jamba-v0.1 (configs/jamba_v01_52b.py) with the long-context
# window at full width, its depth cut to one period of 8 layers
SSM_ARCH = "mamba2_130m"
SSM_PREFILL = (8, 4096)     # sequences x tokens: train_4k's length
SSM_TRAIN_STEPS = 10
SSM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=SSM_TRAIN_STEPS)
SSM_RESTART = (5, 7)        # save_every, the step a device is lost
# decode vs forward in fp32: the recurrence against the chunked scan,
# the same function up to fp32 summation order; a bf16 decode rounds its
# state to bf16 every step, as the reference does, so its agreement is
# printed and not held (tests/test_models.py holds it at 0.9 on the CPU)
SSM_FP32_AGREE = 0.99
JAMBA_LAYERS = 8            # one period: 1 attention, 7 Mamba2, 4 MoE
JAMBA_PREFILL = (1, 8192)   # the window (4,096) cuts its attention
JAMBA_GEN = (4, 128, 16)    # prompts, prompt tokens, new tokens
# the ring buffer on the card: the window cut to 128, prompts of 160
# tokens replayed and 32 decoded (the buffer of 128 rows wraps), in fp32
# at capacity_factor E/k (no group drops a token)
JAMBA_RING = (4, 160, 32, 128)   # prompts, prompt tokens, decoded, window
JAMBA_RING_LAYERS = 8
JAMBA_FP32_AGREE = 0.99


def leading_ops(fn, label, top=5):
    """fn() under torch.profiler: the ``top`` aten operations by the
    device time of the kernels each launched itself (self device time,
    so that nested operations count once), each with its share of the
    busy time; returns the busy ms."""
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
    opsl = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")
            and e.self_device_time_total > 0]
    opsl.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile, {label}: {wall:.1f} ms wall (profiler on), device "
          f"busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}; the "
          f"{top} leading operations by their kernels' device time:")
    for e in opsl[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms  {ms / busy:.3f} of busy  x{e.count:<5d} "
              f"{e.key[:80]}")
    return busy


def phase_ssm(seed: int) -> int:
    """Mamba2-130M at its published width and depth (24 layers, d 768,
    24 SSD heads of 64, state 128, chunk 256), random weights from the
    seed: ``forward`` at ``SSM_PREFILL`` in bf16 (ms, tokens/s, peak, the
    leading device operations of one profiled forward); ``generate`` over
    ``LM_GEN``'s prompts and ``BatchedServer`` (16 requests through 8
    slots), each bitwise a fresh replay of the same calls, and the 8
    prompts admitted together bitwise ``generate``'s tokens; decode
    against forward in fp32 (argmax agreement above ``SSM_FP32_AGREE``)
    and in bf16 (printed); ``train`` for ``SSM_TRAIN_STEPS`` AdamW steps
    of ``SSM_PREFILL`` tokens with remat (the loss falls), and a run that
    loses its device and restarts from the step-5 checkpoint ending on
    the uninterrupted run's bits.  The SSD scan is PyTorch on tensors (the
    reference has no Pallas kernel for it): the path launches no
    hand-written kernel, and the launch counts say so."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureSim

    cfg = get_config(SSM_ARCH)
    model = init_model(cfg, seed=seed, device="cuda")
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"model {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner_ssm}, {cfg.ssm_heads} SSD "
          f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, conv {cfg.conv_width}, vocab {cfg.vocab_size} "
          f"(tied); {param_count(cfg)[0]:,} parameters, {held / 1e9:.3f} GB "
          f"held (bf16, dt_bias/A_log/D and the norms fp32); random weights "
          f"from seed {seed}; fp32 matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    stream = TokenStream(cfg.vocab_size, seed)
    ops.reset_launch_counts()

    # forward: the first call, then three timed
    B, S = SSM_PREFILL
    toks = torch.from_numpy(stream.batch(0, B, S)[:, :S]).cuda()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError(f"ssm forward: logits {tuple(logits.shape)} "
                             f"{logits.dtype}, aux {float(aux)}")
    del logits
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(fwd_ms)
    print(f"ssm forward B={B} S={S}: first {first_ms:.1f} ms, then "
          + ", ".join(f"{t:.1f}" for t in fwd_ms) + f" ms (median {med:.1f}"
          f" ms, {B * S / med * 1e3:.0f} tokens/s); peak device memory "
          f"{peak / 1e9:.2f} GB")
    leading_ops(lambda: forward(model, cfg, {"tokens": toks}),
                f"one Mamba2-130M forward B={B} S={S}")
    del toks

    # generate, and a fresh replay of the same call
    nb, s0, max_new = LM_GEN
    prompts = stream.batch(1, nb, s0)[:, :s0]
    t0 = time.perf_counter()
    gen_toks = tserve.generate(cfg, model, prompts, max_new=max_new)
    gen_s = time.perf_counter() - t0
    again = tserve.generate(cfg, model, prompts, max_new=max_new)
    if gen_toks.shape != (nb, s0 + max_new) or not np.array_equal(
            gen_toks, again):
        raise AssertionError("ssm generate: a fresh replay differs")
    caches = tserve.init_serve_cache(model, cfg, nb, s0 + max_new,
                                     prefilled=s0)
    step1 = gen_toks[:, s0:s0 + 1]
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        tserve.serve_step(model, cfg, caches, step1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del caches
    print(f"ssm generate B={nb}, {s0} prompt + {max_new} new tokens: "
          f"{gen_s:.2f} s, a fresh replay the same tokens bitwise; "
          f"serve_step median {statistics.median(step_ms):.2f} ms at B={nb} "
          f"({nb / statistics.median(step_ms) * 1e3:.0f} tokens/s)")
    srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in srv.run()}
    if not np.array_equal(np.asarray([done[i]["generated"] for i in ids]),
                          gen_toks[:, s0:]):
        raise AssertionError("ssm BatchedServer: the prompts admitted "
                             "together differ from generate's tokens")
    reqs = stream.batch(2, LM_REQUESTS, s0)[:, :s0]
    answers, walls = [], []
    for _ in range(2):
        srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                                   max_len=LM_MAX_LEN)
        ids = [srv.submit(p, max_new=max_new) for p in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {r["id"]: r for r in srv.run()}
        walls.append(time.perf_counter() - t0)
        answers.append([done[i]["generated"] for i in ids])
    n_new = sum(len(a) for a in answers[0])
    if answers[0] != answers[1] or n_new != LM_REQUESTS * max_new:
        raise AssertionError("ssm BatchedServer: a fresh replay of the 16 "
                             "requests differs")
    print(f"ssm BatchedServer, {LM_REQUESTS} requests of {s0} + {max_new} "
          f"tokens through {LM_SLOTS} slots: {walls[0]:.2f} s, "
          f"{n_new / walls[0]:.1f} generated tokens/s; a fresh replay the "
          f"same tokens bitwise; the {nb} prompts admitted together answer "
          "generate's tokens bitwise (a slot's next request starts from "
          "the state its predecessor left, as in the reference)")
    del srv

    # decode against forward: bf16 (printed), then the model in fp32
    def replay(m, c):
        par, _ = forward(m, c, {"tokens": prompts})
        caches = tserve.init_serve_cache(m, c, nb, s0)
        dec = []
        for i in range(s0):
            lg, caches = tserve.serve_step(m, c, caches, prompts[:, i:i + 1])
            dec.append(lg[:, 0])
        return torch.stack(dec, 1), par

    decode_agreement(*replay(model, cfg), f"ssm bf16 decode vs forward at "
                     f"all {nb} x {s0} prompt positions (printed, not held: "
                     "a bf16 decode rounds its state every step)")
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"ssm: launch counts {counts}, want none")
    print(f"ssm path launches {counts}: the SSD scan, the conv and decode "
          "are PyTorch on tensors (the reference has no Pallas kernel "
          "there), so the path launches no hand-written kernel")
    del model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = init_model(cfg32, seed=seed, device="cuda")
    agree = decode_agreement(*replay(model32, cfg32), f"ssm fp32 decode vs "
                             f"forward at all {nb} x {s0} prompt positions")
    if not agree > SSM_FP32_AGREE:
        raise AssertionError(f"ssm fp32 decode vs forward: argmax agreement "
                             f"{agree} (want > {SSM_FP32_AGREE})")
    del model32
    gc.collect()
    torch.cuda.empty_cache()

    # training, and a restart from the step-5 checkpoint
    opt = AdamWConfig(**SSM_TRAIN_OPT)
    torch.cuda.reset_peak_memory_stats()
    every, lost = SSM_RESTART
    with tempfile.TemporaryDirectory() as d:
        with timed_steps() as spans:
            t0 = time.perf_counter()
            run = ttrain.train(cfg, steps=SSM_TRAIN_STEPS, batch=B, seq=S,
                               opt_cfg=opt, seed=seed, log_every=0)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        sim = FailureSim(fail_at=[lost])
        cut = ttrain.train(cfg, steps=SSM_TRAIN_STEPS, batch=B, seq=S,
                           opt_cfg=opt, seed=seed, log_every=0, ckpt_dir=d,
                           save_every=every, failure_sim=sim)
    losses = run["losses"]
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if len(losses) != SSM_TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not last < first:
        raise AssertionError(f"ssm train: losses {losses}")
    if sim.failures != 1 or cut["final_step"] != SSM_TRAIN_STEPS \
            or len(cut["losses"]) != SSM_TRAIN_STEPS + lost - every:
        raise AssertionError(f"ssm restart: {sim.failures} failures, "
                             f"{len(cut['losses'])} steps run")
    _same_training_state((cut["params"], cut["opt_state"]),
                         (run["params"], run["opt_state"]),
                         "ssm restart after FailureSim")
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"ssm train: launch counts {counts}")
    step_med = statistics.median(spans[1:])
    print(f"ssm train: {SSM_TRAIN_STEPS} steps of {B} x {S} tokens, remat "
          f"on, in {wall:.1f} s wall; step ms "
          + " ".join(f"{t * 1e3:.1f}" for t in spans)
          + f"; median after the first {step_med * 1e3:.1f} ms, "
          f"{B * S / step_med:.0f} tokens/s; peak device memory "
          f"{peak / 1e9:.2f} GB; loss {first:.4f} -> {last:.4f} (means of "
          "the first and last three): " + " ".join(f"{x:.4f}"
                                                    for x in losses))
    print(f"ssm train: a device lost at step {lost}, resumed from step "
          f"{lost // every * every}'s checkpoint ({len(cut['losses'])} steps "
          "run), ends on the uninterrupted run's bits (params, m, v, step)")
    del run, cut
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash"]


def phase_jamba(seed: int, gen):
    """Jamba-v0.1's long-context config (attention with a 4,096-token
    window) at full width, cut to one period of ``JAMBA_LAYERS`` layers,
    random bf16 weights from the seed.  First, before the model, the
    windowed flash kernel at Jamba's shape (``JAMBA_PREFILL``, 32/8 heads
    of 128, causal) against its plain version, timed in turns beside the
    same call without the window, SDPA with the window as a mask, and
    the plain version.  Then ``forward`` at ``JAMBA_PREFILL`` (ms,
    tokens/s, peak; flash launched once a forward, on ``flash_sm90``),
    ``generate`` at ``JAMBA_GEN`` (a fresh replay bitwise) and
    ``BatchedServer`` (the prompts admitted together: generate's tokens
    bitwise).  Last, the ring buffer: the window cut to 128, the model
    in fp32 at capacity_factor E/k, ``JAMBA_RING``'s prompts replayed and
    decoded through a cache of 128 rows that wraps, held against one
    forward at the same window.  Returns (the flash launches of the
    main path, the windowed call's entry)."""
    import numpy as np
    import torch
    from repro_torch.configs import jamba_v01_52b
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as tserve
    from repro_torch.models import forward, init_model, param_count

    full = jamba_v01_52b.config(long_context=True).validate()
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    window = max(s.window for s in cfg.pattern)
    B, S = JAMBA_PREFILL
    bf16 = torch.bfloat16
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    # the windowed flash at Jamba's shape
    q, k, v = (torch.randn(*s, device="cuda", generator=gen).to(bf16)
               for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
    out = kflash.launch("flash_sm90", q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = ref.check_attention(out, q, k, v, causal=True, window=window,
                              what=f"flash window {window}")
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window)

    def sdpa_window():
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    lib_err = (sdpa_window().float()
               - ref.attention_ref(q, k, v, causal=True, window=window)
               .float()).abs().max().item()
    fns = {"window": lambda: kflash.launch("flash_sm90", q, k, v,
                                           causal=True, window=window),
           "no window": lambda: kflash.launch("flash_sm90", q, k, v,
                                              causal=True),
           "SDPA (mask)": sdpa_window,
           "plain": lambda: ref.attention_ref(q, k, v, causal=True,
                                              window=window)}
    times = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            times[n].append(time_ms(fns[n], n=3 if n == "plain" else 20))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    b_ms, b_by, n_ops = flash_bound(q.shape, k.shape, window=window)
    nb_ms = flash_bound(q.shape, k.shape)[0]
    print(f"flash_sm90 at Jamba's shape b{B} s{S} h{H}/{KVH} hd{hd} bf16 "
          f"causal, window {window}: max abs err {err:.3e} against the plain "
          f"version (SDPA with the window as a mask: {lib_err:.3e}); bound "
          f"{b_ms:.3f} ms by {b_by} ({n_ops / 1e9:.1f} GFLOP; without the "
          f"window {nb_ms:.3f}); two rounds in turns, mean:")
    for n, t in times.items():
        print(f"    {n}: {ms[n]:.3f} ms ({', '.join(f'{x:.3f}' for x in t)})")
    print(f"  windowed / unwindowed {ms['window'] / ms['no window']:.3f} "
          f"(visible pairs {b_ms / nb_ms:.3f}), windowed / SDPA "
          f"{ms['window'] / ms['SDPA (mask)']:.3f}")
    entry = {"shape": f"b{B} s{S} h{H}/{KVH} hd{hd} bf16 causal window "
             f"{window}", "max_abs_err": err, "ms": ms["window"],
             "unwindowed_ms": ms["no window"], "plain_ms": ms["plain"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": ms["SDPA (mask)"],
             "library_note": "SDPA with the window as a boolean mask"}
    del q, k, v, out, mask, fns
    gc.collect()
    torch.cuda.empty_cache()

    # the model: one period at full width, bf16
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"model {cfg.name}, config(long_context=True) at full width: d_model "
          f"{cfg.d_model}, {H}/{KVH} heads of {hd} with a window of {window}"
          f", d_ff {cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k} (d_ff "
          f"{cfg.d_ff_expert}), Mamba2 with {cfg.ssm_heads} SSD heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab "
          f"{cfg.vocab_size}; depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers (one period: attention at 3, Mamba2 "
          f"elsewhere, MoE on the odd layers): {param_count(cfg)[0]:,} "
          f"parameters of {param_count(full)[0]:,}, {held / 1e9:.2f} GB of "
          f"random bf16 weights from seed {seed}, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    stream = TokenStream(cfg.vocab_size, seed)
    toks = torch.from_numpy(stream.batch(0, B, S)[:, :S]).cuda()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()) \
            or not (torch.isfinite(aux) and float(aux) > 0):
        raise AssertionError(f"jamba forward: logits {tuple(logits.shape)}, "
                             f"aux {float(aux)}")
    del logits
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.repeats
    med = statistics.median(fwd_ms)
    print(f"jamba forward B={B} S={S}: first {first_ms:.1f} ms, then "
          + ", ".join(f"{t:.1f}" for t in fwd_ms) + f" ms (median {med:.1f} "
          f"ms, {B * S / med * 1e3:.0f} tokens/s); aux {float(aux):.4f}; "
          f"peak device memory {peak / 1e9:.2f} GB; flash launches "
          f"{ops.launch_counts()['flash']} in 4 forwards, by source "
          f"{kflash.design_launches}")
    leading_ops(lambda: forward(model, cfg, {"tokens": toks}),
                f"one Jamba forward B={B} S={S}")
    del toks

    nb, s0, max_new = JAMBA_GEN
    prompts = stream.batch(1, nb, s0)[:, :s0]
    t0 = time.perf_counter()
    gen_toks = tserve.generate(cfg, model, prompts, max_new=max_new)
    gen_s = time.perf_counter() - t0
    if gen_toks.shape != (nb, s0 + max_new) or not np.array_equal(
            gen_toks, tserve.generate(cfg, model, prompts, max_new=max_new)):
        raise AssertionError("jamba generate: a fresh replay differs")
    srv = tserve.BatchedServer(cfg, model, slots=nb, max_len=LM_MAX_LEN)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {r["id"]: r for r in srv.run()}
    srv_s = time.perf_counter() - t0
    if not np.array_equal(np.asarray([done[i]["generated"] for i in ids]),
                          gen_toks[:, s0:]):
        raise AssertionError("jamba BatchedServer: the prompts admitted "
                             "together differ from generate's tokens")
    print(f"jamba generate B={nb}, {s0} prompt + {max_new} new tokens: "
          f"{gen_s:.2f} s, a fresh replay the same tokens bitwise; "
          f"BatchedServer ({nb} slots, the same prompts): {srv_s:.2f} s "
          f"({(s0 + max_new) / srv_s:.1f} steps/s), generate's tokens "
          "bitwise")
    del srv
    counts = ops.launch_counts()
    # four timed forwards, the profiled one and generate's two prefills,
    # one launch each of the period's attention layer; decode runs no
    # flash kernel
    want = {**dict.fromkeys(counts, 0), "flash": n_attn * (5 + 2)}
    if counts != want or kflash.design_launches["flash_sm90"] != \
            want["flash"]:
        raise AssertionError(f"jamba: launch counts {counts} "
                             f"({kflash.design_launches} by source), want "
                             f"{want}, all flash on flash_sm90")
    print(f"jamba path launches {counts}: flash_sm90 (windowed) once a "
          "forward (four timed, one profiled, generate's two prefills); "
          "decode reads the ring buffer in PyTorch")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the ring buffer on the card, in fp32 without drops
    rb, rs0, rnew, rwin = JAMBA_RING
    ring = _windowed_cfg(dataclasses.replace(
        cfg, n_layers=JAMBA_RING_LAYERS, dtype="float32",
        capacity_factor=cfg.n_experts / cfg.top_k), rwin)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(ring, seed=seed, device="cuda")
    prompts = stream.batch(2, rb, rs0)[:, :rs0]
    caches = tserve.init_serve_cache(model, ring, rb, rs0 + rnew)
    rows = caches["stack"][3]["mixer"]["k"].shape[1]
    dec, fed = [], prompts
    lg = None
    for i in range(rs0 + rnew):
        tok = prompts[:, i:i + 1] if i < rs0 else \
            lg[:, -1].argmax(-1, keepdim=True).cpu().numpy()
        if i >= rs0:
            fed = np.concatenate([fed, tok], axis=1)
        lg, caches = tserve.serve_step(model, ring, caches, tok)
        dec.append(lg[:, 0])
    par, _ = forward(model, ring, {"tokens": fed})
    torch.cuda.synchronize()
    if rows != rwin or caches["pos"] != rs0 + rnew:
        raise AssertionError(f"jamba ring: {rows} rows, position "
                             f"{caches['pos']}")
    agree = decode_agreement(
        torch.stack(dec, 1), par,
        f"jamba ring buffer, fp32, window {rwin} ({rows} cache rows), "
        f"{ring.n_layers} layers, capacity_factor {ring.capacity_factor}: "
        f"decode vs forward at {rb} x {rs0 + rnew} positions ({rs0} "
        f"replayed, {rnew} decoded)")
    print(f"  fp32 model {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"peak; {time.perf_counter() - t0:.1f} s")
    if not agree > JAMBA_FP32_AGREE:
        raise AssertionError(f"jamba ring buffer: argmax agreement {agree} "
                             f"(want > {JAMBA_FP32_AGREE})")
    del model, caches, par, dec
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash"], entry


def _windowed_cfg(cfg, window):
    """cfg with its attention layers' window set to ``window``."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window if s.mixer == "attn" else 0)
        for s in cfg.pattern))


WHISPER_ARCH = "whisper_medium"
# prompts x decoder tokens, each over the encoder's 1,500 frames: the
# config's decoder length (configs/whisper_medium.py DECODER_LEN)
WHISPER_PREFILL = (8, 448)
WHISPER_DECODE_STEPS = 32
WHISPER_TRAIN_STEPS = 10
WHISPER_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2,
                         total_steps=WHISPER_TRAIN_STEPS)
WHISPER_RESTART = (5, 7)    # save_every, the step a device is lost
WHISPER_RESTART_LAYERS = 2  # encoder and decoder layers of the restart
# the fp32 checks: full width cut to 2 encoder + 2 decoder layers on the
# card against the port's CPU forward (1 prompt of 448 tokens over 1,500
# frames); decode against forward at full depth (prompts, tokens)
WHISPER_FP32_LAYERS = 2
WHISPER_FP32_DECODE = (4, 64)
WHISPER_FP32_AGREE = 0.99
VL_ARCH = "internvl2_2b"
# prompts x text tokens, 256 patch embeddings before each: 4,096
# positions, train_4k's length
VL_PREFILL = (4, 3840)
VL_FP32_LAYERS = 2
VL_FP32_TEXT = 64
# training: full width, depth cut to 8 of 24 layers (full depth needs
# about 30 GB of fp32 training state plus AdamW's six fp32 copies of the
# parameters at its peak), 2 x (256 + 3,840) positions a step
VL_TRAIN_LAYERS = 8
VL_TRAIN = (2, 3840)
VL_TRAIN_STEPS = 10
VL_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=VL_TRAIN_STEPS)
# fp32 on the card against the port's fp32 CPU forward on the same
# weights: the kernels' fp32 attention and cuBLAS sum in other orders
# than the plain versions and MKL, about 1e-6 relative an operation,
# grown through a few layers and a 1,024- or 2,048-wide LayerNorm or
# RMSNorm; held at 1e-4 relative plus 1e-4 of the largest |logit|
CARD_CPU_TOL = dict(rtol=1e-4, atol_of_max=1e-4)


def card_vs_cpu(cfg, batch, seed, label):
    """``cfg`` (fp32) built from ``seed`` on the CPU and copied to the
    card: the card's ``forward`` against the CPU's on ``batch`` (numpy
    arrays), within ``CARD_CPU_TOL``; returns the max |diff|."""
    import copy
    import torch
    from repro_torch.models import forward, init_model
    cpu = init_model(cfg, seed=seed, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    t0 = time.perf_counter()
    want, _ = forward(cpu, cfg, batch)
    cpu_s = time.perf_counter() - t0
    got, _ = forward(card, cfg, batch)
    got = got.float().cpu()
    diff = (got - want).abs()
    top = float(want.abs().max())
    tol = CARD_CPU_TOL["rtol"] * want.abs() + CARD_CPU_TOL["atol_of_max"] * top
    print(f"{label}: fp32 forward on the card against the port's CPU forward "
          f"on the same weights ({cpu_s:.1f} s on the CPU): max |diff| "
          f"{float(diff.max()):.3e} (largest |logit| {top:.3f}), argmax "
          f"agreement {float((got.argmax(-1) == want.argmax(-1)).float().mean()):.4f}"
          f"; tolerance {CARD_CPU_TOL}")
    if not bool(torch.isfinite(got).all()) or bool((diff > tol).any()):
        raise AssertionError(f"{label}: the card's fp32 forward is outside "
                             f"{CARD_CPU_TOL} of the CPU's")
    del cpu, card
    return float(diff.max())


@contextlib.contextmanager
def timed_steps():
    """Within the block, every step that ``launch.train``'s
    ``make_train_step`` builds is timed on the host clock between two
    synchronizations; yields the list its seconds are appended to."""
    import torch
    from repro_torch.launch import train as ttrain
    spans = []
    orig = ttrain.make_train_step

    def timed_make(*a, **kw):
        step = orig(*a, **kw)

        def timed(*x):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step(*x)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t)
            return r
        return timed

    ttrain.make_train_step = timed_make
    try:
        yield spans
    finally:
        ttrain.make_train_step = orig


def noncausal_kernels(gen, q_shape, kv_shape, label):
    """The non-causal flash forward and backward at one shape (bf16,
    G = 1): each against its plain version, the forward's SDPA (no mask)
    and the backward's SDPA backward checked too, then timed in two
    rounds in turns beside them.  Returns ({forward's numbers},
    {backward's numbers})."""
    import torch
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ref
    bf16 = torch.bfloat16

    def rand(shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf16)

    q, k, v, g = rand(q_shape), rand(kv_shape), rand(kv_shape), \
        rand(q_shape)
    src = kflash.design(bf16, q_shape[3])
    bsrc = kbwd.design(bf16, q_shape[3], kv_shape[3])
    lse = torch.empty(q_shape[0], q_shape[2], q_shape[1], device="cuda")
    out = kflash.launch(src, q, k, v, causal=False, lse=lse)
    torch.cuda.synchronize()
    err = ref.check_attention(out, q, k, v, causal=False,
                              what=f"flash {label}")
    lib_err = (sdpa(q, k, v, causal=False).float()
               - ref.attention_ref(q, k, v, causal=False).float()
               ).abs().max().item()
    grads = kbwd.launch(bsrc, q, k, v, out, lse, g, causal=False)
    torch.cuda.synchronize()
    berr = ref.check_attention_bwd(grads, q, k, v, out, lse, g,
                                   causal=False, what=f"flash_bwd {label}")
    lib_bwd = sdpa_bwd(q, k, v, g, causal=False)
    want = ref.attention_bwd_ref(q, k, v, out, lse, g, causal=False)
    # SDPA's gradients come in its (B, H, S, hd) layout
    lib_berr = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                   for a, b in zip(lib_bwd(), want))
    del grads, want
    print(f"  {label} q {tuple(q_shape)} kv {tuple(kv_shape)} bf16 "
          f"non-causal: flash on {src} max abs err {err:.3e} (SDPA without "
          f"a mask {lib_err:.3e}); flash_bwd on {bsrc} {berr:.3e} (SDPA's "
          f"backward {lib_berr:.3e}); SDPA's backward ran "
          f"{device_kernels(lib_bwd, 2)}")
    fwd = {src: lambda: kflash.launch(src, q, k, v, causal=False),
           "SDPA": lambda: sdpa(q, k, v, causal=False),
           "plain": lambda: ref.attention_ref(q, k, v, causal=False)}
    bwd = {bsrc: lambda: kbwd.launch(bsrc, q, k, v, out, lse, g,
                                     causal=False),
           "SDPA backward": lib_bwd,
           "plain": lambda: ref.attention_bwd_ref(q, k, v, out, lse, g,
                                                  causal=False)}
    res = []
    for what, fns, bound_fn in (
            ("flash", fwd, flash_bound), ("flash_bwd", bwd, flash_bwd_bound)):
        times = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                times[n].append(time_ms(fns[n], n=5 if n == "plain"
                                        else 20))
        ms = {n: sum(t) / len(t) for n, t in times.items()}
        b_ms, b_by, n_ops = bound_fn(q_shape, kv_shape, causal=False)
        kern = src if what == "flash" else bsrc
        print(f"  {what} {label}: bound {b_ms:.3f} ms by {b_by} "
              f"({n_ops / 1e9:.1f} GFLOP); two rounds in turns, mean: "
              + ", ".join(f"{n} {ms[n]:.3f} ms ("
                          + ", ".join(f"{x:.3f}" for x in t) + ")"
                          for n, t in times.items())
              + f"; {kern} {n_ops / ms[kern] / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms[kern]:.3f} of the bound, "
              f"{ms[kern] / ms[[n for n in ms if n.startswith('SDPA')][0]]:.3f}"
              " of SDPA's time")
        lib = [n for n in ms if n.startswith("SDPA")][0]
        res.append({"shape": f"q {tuple(q_shape)} kv {tuple(kv_shape)} "
                    "bf16 non-causal", "max_abs_err": err if what == "flash"
                    else berr, "ms": ms[kern], "plain_ms": ms["plain"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": ms[lib]})
    del q, k, v, g, out, lse, fwd, bwd, lib_bwd
    torch.cuda.empty_cache()
    return res[0], res[1]


def phase_whisper(seed: int, gen):
    """Whisper-medium at its published width and depth (24 encoder + 24
    decoder layers, d 1,024, 16 heads of 64, d_ff 4,096, vocab 51,872,
    1,500 encoder frames), random bf16 weights from the seed.  First the
    non-causal flash forward and backward at the encoder's shape (8 x
    1,500, 16 heads of 64, self) and the cross blocks' (8 x 448 queries
    over 1,500 keys) against their plain versions and SDPA's, timed.
    Then ``forward`` at ``WHISPER_PREFILL`` over 1,500 frames (ms,
    tokens/s, peak, the leading device operations; 72 flash launches a
    forward: 24 encoder, 24 decoder self, 24 cross), ``encode`` ->
    ``init_serve_cache(enc_out=)`` -> ``WHISPER_DECODE_STEPS``
    ``serve_step``s; the fp32 checks (the card's forward at full width
    cut to 2 + 2 layers against the CPU's; decode against forward at
    full depth); ``train`` for ``WHISPER_TRAIN_STEPS`` AdamW steps of
    ``WHISPER_PREFILL`` tokens with remat (144 flash and 72 flash_bwd
    launches a step; the loss falls); and at full width cut to
    ``WHISPER_RESTART_LAYERS`` + ``WHISPER_RESTART_LAYERS`` layers a run
    restarted after a lost device, bitwise the uninterrupted one.
    Returns (the non-causal
    forward's kernels-line entry, the backward's)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_lm_batch
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import (encode, forward, init_model,
                                    init_serve_cache, param_count,
                                    serve_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureSim

    cfg = get_config(WHISPER_ARCH)
    B, S = WHISPER_PREFILL
    Te, H, hd = cfg.encoder_frames, cfg.n_heads, cfg.head_dim
    enc_f, enc_b = noncausal_kernels(gen, (B, Te, H, hd), (B, Te, H, hd),
                                     f"encoder b{B} s{Te} h{H} hd{hd}")
    cross_f, cross_b = noncausal_kernels(gen, (B, S, H, hd), (B, Te, H, hd),
                                         f"cross b{B} sq{S} sk{Te} h{H} "
                                         f"hd{hd}")

    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"model {cfg.name}: {cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers (self, cross, GELU MLP), d_model "
          f"{cfg.d_model}, {H} heads of {hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, LayerNorm, sinusoidal positions; "
          f"{param_count(cfg)[0]:,} parameters, {held / 1e9:.2f} GB held "
          f"(bf16, the norms fp32); random weights from seed {seed} drawn "
          f"in {time.perf_counter() - t0:.1f} s; fp32 matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    stream = TokenStream(cfg.vocab_size, seed)
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    toks = torch.from_numpy(stream.batch(0, B, S)[:, :S]).cuda()
    frames = torch.randn(B, Te, cfg.d_model, device="cuda", generator=gen)
    batch = {"tokens": toks, "enc_frames": frames}
    ops.reset_launch_counts()
    before = dict(kflash.design_launches)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = forward(model, cfg, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()) or float(aux) != 0.0:
        raise AssertionError(f"whisper forward: logits "
                             f"{tuple(logits.shape)} {logits.dtype}")
    del logits
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, batch)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(fwd_ms)
    sm90 = kflash.design_launches["flash_sm90"] - before["flash_sm90"]
    if ops.launch_counts()["flash"] != 4 * n_attn or sm90 != 4 * n_attn:
        raise AssertionError(f"whisper forward: {ops.launch_counts()} "
                             f"({sm90} on flash_sm90) in 4 forwards, want "
                             f"{n_attn} each, all on flash_sm90")
    print(f"whisper forward B={B}, {Te} frames + {S} tokens: first "
          f"{first_ms:.1f} ms, then " + ", ".join(f"{t:.1f}" for t in fwd_ms)
          + f" ms (median {med:.1f} ms, {B * S / med * 1e3:.0f} decoder "
          f"tokens/s beside {B * Te / med * 1e3:.0f} frames/s); peak device "
          f"memory {peak / 1e9:.2f} GB; flash launches {n_attn} a forward "
          f"({cfg.n_encoder_layers} encoder, {cfg.n_layers} decoder self, "
          f"{cfg.n_layers} cross), all on flash_sm90")
    leading_ops(lambda: forward(model, cfg, batch),
                f"one Whisper-medium forward B={B}, {Te} frames + {S} tokens")

    # decode: encode, the cross K/V once, then greedy steps at B
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encode(model, cfg, frames)
    caches = init_serve_cache(model, cfg, B, S, enc_out=enc)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    tok = toks[:, :1]
    step_ms = []
    for _ in range(WHISPER_DECODE_STEPS):
        t0 = time.perf_counter()
        lg, caches = serve_step(model, cfg, caches, tok)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if caches["pos"] != WHISPER_DECODE_STEPS \
            or not bool(torch.isfinite(lg.float()).all()):
        raise AssertionError(f"whisper decode: position {caches['pos']}")
    dec_med = statistics.median(step_ms[1:])
    print(f"whisper decode B={B}: encode + init_serve_cache(enc_out=) "
          f"{setup_ms:.1f} ms ({cfg.n_layers} cross K/V of {Te} rows), then "
          f"{WHISPER_DECODE_STEPS} greedy serve_steps: median "
          f"{dec_med:.2f} ms ({B / dec_med * 1e3:.0f} tokens/s; first "
          f"{step_ms[0]:.2f} ms)")
    del caches, enc, lg
    counts = ops.launch_counts()
    if counts["flash"] != 5 * n_attn + cfg.n_encoder_layers:
        raise AssertionError(f"whisper: {counts}, want "
                             f"{5 * n_attn + cfg.n_encoder_layers} flash "
                             "launches (5 forwards, one encode; decode "
                             "none)")
    print(f"whisper serving path launches {counts}: {n_attn} a forward (4 "
          f"timed, 1 profiled), {cfg.n_encoder_layers} in encode; decode's "
          "self and cross attention are PyTorch, as the reference's")
    serve_launches = counts["flash"]
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32: the card against the CPU at 2 + 2 layers, then decode
    # against forward at full depth
    rng = np.random.default_rng(seed)
    c2 = dataclasses.replace(cfg, dtype="float32",
                             n_layers=WHISPER_FP32_LAYERS,
                             n_encoder_layers=WHISPER_FP32_LAYERS)
    card_vs_cpu(c2, {"tokens": stream.batch(3, 1, S)[:, :S],
                     "enc_frames": rng.normal(size=(1, Te, cfg.d_model))
                     .astype(np.float32)}, seed,
                f"whisper {WHISPER_FP32_LAYERS} + {WHISPER_FP32_LAYERS} "
                f"layers at full width, 1 x ({Te} frames + {S} tokens)")
    c32 = dataclasses.replace(cfg, dtype="float32")
    m32 = init_model(c32, seed=seed, device="cuda")
    nb, s0 = WHISPER_FP32_DECODE
    ptoks = stream.batch(4, nb, s0)[:, :s0]
    pframes = torch.randn(nb, Te, cfg.d_model, device="cuda", generator=gen)
    par, _ = forward(m32, c32, {"tokens": ptoks, "enc_frames": pframes})
    caches = init_serve_cache(m32, c32, nb, s0,
                              enc_out=encode(m32, c32, pframes))
    dec = []
    for i in range(s0):
        lg, caches = serve_step(m32, c32, caches, ptoks[:, i:i + 1])
        dec.append(lg[:, 0])
    agree = decode_agreement(torch.stack(dec, 1), par,
                             f"whisper fp32 decode vs forward at all {nb} x "
                             f"{s0} positions over {Te} frames, full depth")
    if not agree > WHISPER_FP32_AGREE:
        raise AssertionError(f"whisper fp32 decode vs forward: argmax "
                             f"agreement {agree} (want > "
                             f"{WHISPER_FP32_AGREE})")
    del m32, caches, par, dec
    gc.collect()
    torch.cuda.empty_cache()

    # training, and a restart from the step-5 checkpoint
    opt = AdamWConfig(**WHISPER_TRAIN_OPT)
    ops.reset_launch_counts()
    bwd_before = dict(kbwd.design_launches)
    torch.cuda.reset_peak_memory_stats()
    with timed_steps() as spans:
        t0 = time.perf_counter()
        run = ttrain.train(cfg, steps=WHISPER_TRAIN_STEPS, batch=B, seq=S,
                           opt_cfg=opt, seed=seed, log_every=0)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    bwd_sm90 = kbwd.design_launches["flash_bwd_sm90"] \
        - bwd_before["flash_bwd_sm90"]
    losses = run["losses"]
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if len(losses) != WHISPER_TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not last < first:
        raise AssertionError(f"whisper train: losses {losses}")
    want = {"flash": 2 * n_attn * WHISPER_TRAIN_STEPS,
            "flash_bwd": n_attn * WHISPER_TRAIN_STEPS}
    if counts["flash"] != want["flash"] or counts["flash_bwd"] != \
            want["flash_bwd"] or bwd_sm90 != want["flash_bwd"]:
        raise AssertionError(f"whisper train: launches {counts} "
                             f"({bwd_sm90} flash_bwd on flash_bwd_sm90), "
                             f"want {want}")
    step_med = statistics.median(spans[1:])
    print(f"whisper train: {WHISPER_TRAIN_STEPS} steps of {B} x ({Te} "
          f"frames + {S} tokens), remat on, in {wall:.1f} s wall; step ms "
          + " ".join(f"{t * 1e3:.1f}" for t in spans)
          + f"; median after the first {step_med * 1e3:.1f} ms, "
          f"{B * S / step_med:.0f} decoder tokens/s; peak device memory "
          f"{peak / 1e9:.2f} GB; launches a step: flash "
          f"{counts['flash'] // WHISPER_TRAIN_STEPS} (forward and the "
          f"remat recompute), flash_bwd "
          f"{counts['flash_bwd'] // WHISPER_TRAIN_STEPS}, all on "
          f"flash_bwd_sm90; loss {first:.4f} -> {last:.4f} (means of the "
          "first and last three): " + " ".join(f"{x:.4f}" for x in losses))

    # the restart at full width, cut in depth: at 24 + 24 layers each of
    # its two checkpoints writes 9.7 GB (about 45 s of the phase)
    cr = dataclasses.replace(cfg, n_layers=WHISPER_RESTART_LAYERS,
                             n_encoder_layers=WHISPER_RESTART_LAYERS)
    every, lost = WHISPER_RESTART
    kw = dict(steps=WHISPER_TRAIN_STEPS, batch=B, seq=S, opt_cfg=opt,
              seed=seed, log_every=0)
    whole = ttrain.train(cr, **kw)
    sim = FailureSim(fail_at=[lost])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cut = ttrain.train(cr, ckpt_dir=d, save_every=every,
                           failure_sim=sim, **kw)
    cut_s = time.perf_counter() - t0
    if sim.failures != 1 or cut["final_step"] != WHISPER_TRAIN_STEPS \
            or len(cut["losses"]) != WHISPER_TRAIN_STEPS + lost - every:
        raise AssertionError(f"whisper restart: {sim.failures} failures, "
                             f"{len(cut['losses'])} steps run")
    _same_training_state((cut["params"], cut["opt_state"]),
                         (whole["params"], whole["opt_state"]),
                         "whisper restart after FailureSim")
    print(f"whisper train at full width, {cr.n_encoder_layers} + "
          f"{cr.n_layers} layers: a device lost at step {lost}, resumed from "
          f"step {lost // every * every}'s checkpoint ({len(cut['losses'])} "
          f"steps run in {cut_s:.1f} s, saves included), ends on the "
          "uninterrupted run's bits (params, m, v, step)")
    del cut, whole
    step = ttrain.make_train_step(cfg, opt)
    b = make_lm_batch(TokenStream(cfg.vocab_size, seed), WHISPER_TRAIN_STEPS,
                      B, S, d_model=cfg.d_model, enc_frames=Te,
                      device="cuda")
    bwd_ms = dict.fromkeys(("dkdv_kernel", "dq_kernel", "stats_kernel"))
    busy = profile_once(lambda: step(run["params"], run["opt_state"], b),
                        f"one Whisper-medium train step B={B}", sums=bwd_ms)
    print(f"whisper train: flash_bwd's device time a step "
          f"{sum(bwd_ms.values()):.1f} ms of {busy:.1f} busy ("
          f"{sum(bwd_ms.values()) / busy:.3f}; "
          + ", ".join(f"{k} {v:.1f}" for k, v in bwd_ms.items())
          + f"); idle share against the median unprofiled step "
          f"{1 - busy / (step_med * 1e3):.3f}")
    del run, step, b
    gc.collect()
    torch.cuda.empty_cache()

    def entry(name, src, replaces, enc_part, cross_part, launches, note):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(enc_part["max_abs_err"],
                                   cross_part["max_abs_err"]),
                "ms": enc_part["ms"], "plain_ms": enc_part["plain_ms"],
                "bound_ms": enc_part["bound_ms"],
                "bound_by": enc_part["bound_by"],
                "library_ms": enc_part["library_ms"],
                "shape": enc_part["shape"], "cross": cross_part,
                "launches_note": note}

    n_nc = cfg.n_encoder_layers + cfg.n_layers
    fwd = entry("flash (non-causal: Whisper's encoder and cross-attention)",
                "src/repro_torch/kernels/csrc/flash_sm90.cu",
                "src/repro/kernels/flash.py:129", enc_f, cross_f,
                serve_launches + want["flash"],
                f"all flash launches of the whisper phase's model path "
                f"(serving {serve_launches}, training {want['flash']}); "
                f"{n_nc} of each forward's {n_attn} are non-causal")
    bwd = entry("flash_bwd (non-causal: Whisper's encoder and "
                "cross-attention)",
                "src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
                "src/repro/models/layers.py:245", enc_b, cross_b,
                want["flash_bwd"],
                f"the training run's; {n_nc} of each step's {n_attn} are "
                "non-causal")
    return fwd, bwd


def phase_internvl2(seed: int, gen):
    """InternVL2-2B at its published width and depth (24 layers, d
    2,048, 16/8 heads of 128, d_ff 8,192, vocab 92,560, 256 patch
    embeddings prepended), random bf16 weights from the seed:
    ``forward`` at ``VL_PREFILL`` with the patches (ms, positions/s,
    peak, the leading device operations; one flash launch a layer, on
    ``flash_sm90``), ``generate`` text-only over ``LM_GEN``'s prompts and
    ``BatchedServer`` (the same prompts admitted together bitwise
    generate's tokens; then 16 requests through 8 slots); the fp32
    forward at full width cut to ``VL_FP32_LAYERS`` layers with patches,
    the card against the CPU; ``train`` at full width cut to
    ``VL_TRAIN_LAYERS`` layers, ``VL_TRAIN_STEPS`` steps of
    ``VL_TRAIN`` text tokens after the patches, remat on (the loss
    falls; 2 flash and 1 flash_bwd launches a layer a step; flash_bwd's
    share of a profiled step's device time).  Returns the flash and
    flash_bwd launches: {"serving", "train", "train_bwd"}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_lm_batch
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.optim import AdamWConfig

    cfg = get_config(VL_ARCH)
    B, S = VL_PREFILL
    Tf = cfg.n_frontend_tokens
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {Tf} patch embeddings "
          f"prepended; {param_count(cfg)[0]:,} parameters, "
          f"{held / 1e9:.2f} GB of random bf16 weights from seed {seed}, "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    stream = TokenStream(cfg.vocab_size, seed)
    toks = torch.from_numpy(stream.batch(0, B, S)[:, :S]).cuda()
    front = torch.randn(B, Tf, cfg.d_model, device="cuda", generator=gen)
    batch = {"tokens": toks, "frontend": front}
    ops.reset_launch_counts()
    before = dict(kflash.design_launches)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _ = forward(model, cfg, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"internvl2 forward: logits "
                             f"{tuple(logits.shape)}")
    del logits
    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, batch)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        del logits
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(fwd_ms)
    sm90 = kflash.design_launches["flash_sm90"] - before["flash_sm90"]
    if ops.launch_counts()["flash"] != 4 * cfg.n_layers \
            or sm90 != 4 * cfg.n_layers:
        raise AssertionError(f"internvl2 forward: {ops.launch_counts()} "
                             f"({sm90} on flash_sm90) in 4 forwards")
    n_pos = B * (Tf + S)
    print(f"internvl2 forward B={B}, {Tf} patches + {S} tokens: first "
          f"{first_ms:.1f} ms, then " + ", ".join(f"{t:.1f}" for t in fwd_ms)
          + f" ms (median {med:.1f} ms, {n_pos / med * 1e3:.0f} positions/s "
          f"over {n_pos}); peak device memory {peak / 1e9:.2f} GB; flash "
          f"launches {cfg.n_layers} a forward, all on flash_sm90")
    leading_ops(lambda: forward(model, cfg, batch),
                f"one InternVL2-2B forward B={B}, {Tf} + {S}")
    del toks, front, batch

    # generate and BatchedServer, text-only as the reference serves it
    nb, s0, max_new = LM_GEN
    prompts = stream.batch(1, nb, s0)[:, :s0]
    t0 = time.perf_counter()
    gen_toks = tserve.generate(cfg, model, prompts, max_new=max_new)
    gen_s = time.perf_counter() - t0
    srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
    ids = [srv.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in srv.run()}
    if gen_toks.shape != (nb, s0 + max_new) or not np.array_equal(
            np.asarray([done[i]["generated"] for i in ids]),
            gen_toks[:, s0:]):
        raise AssertionError("internvl2 BatchedServer: the prompts admitted "
                             "together differ from generate's tokens")
    reqs = stream.batch(2, LM_REQUESTS, s0)[:, :s0]
    srv = tserve.BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
    for p in reqs:
        srv.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    wall = time.perf_counter() - t0
    n_new = sum(len(r["generated"]) for r in done)
    if len(done) != LM_REQUESTS or n_new != LM_REQUESTS * max_new:
        raise AssertionError(f"internvl2 BatchedServer: {len(done)} done")
    print(f"internvl2 generate B={nb}, {s0} prompt + {max_new} new tokens "
          f"(text-only): {gen_s:.2f} s; BatchedServer: the {nb} prompts "
          f"admitted together answer generate's tokens bitwise; "
          f"{LM_REQUESTS} requests through {LM_SLOTS} slots in {wall:.2f} s, "
          f"{n_new / wall:.1f} generated tokens/s")
    counts = ops.launch_counts()
    want = cfg.n_layers * (5 + 1)
    if counts["flash"] != want or counts["flash_bwd"]:
        raise AssertionError(f"internvl2 serving: {counts}, want {want} "
                             "flash launches")
    print(f"internvl2 serving path launches {counts}: {cfg.n_layers} a "
          "forward (4 timed, 1 profiled, generate's prefill); decode none")
    serve_launches = counts["flash"]
    del model, srv
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed)
    c2 = dataclasses.replace(cfg, dtype="float32", n_layers=VL_FP32_LAYERS)
    card_vs_cpu(c2, {"tokens": stream.batch(3, 1, VL_FP32_TEXT)
                     [:, :VL_FP32_TEXT],
                     "frontend": rng.normal(size=(1, Tf, cfg.d_model))
                     .astype(np.float32)}, seed,
                f"internvl2 {VL_FP32_LAYERS} layers at full width, 1 x ({Tf} "
                f"patches + {VL_FP32_TEXT} tokens)")
    gc.collect()
    torch.cuda.empty_cache()

    # training at full width, depth cut
    c8 = dataclasses.replace(cfg, n_layers=VL_TRAIN_LAYERS)
    tb, ts = VL_TRAIN
    opt = AdamWConfig(**VL_TRAIN_OPT)
    ops.reset_launch_counts()
    bwd_before = dict(kbwd.design_launches)
    torch.cuda.reset_peak_memory_stats()
    with timed_steps() as spans:
        t0 = time.perf_counter()
        run = ttrain.train(c8, steps=VL_TRAIN_STEPS, batch=tb, seq=ts,
                           opt_cfg=opt, seed=seed, log_every=0)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    bwd_sm90 = kbwd.design_launches["flash_bwd_sm90"] \
        - bwd_before["flash_bwd_sm90"]
    losses = run["losses"]
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if len(losses) != VL_TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not last < first:
        raise AssertionError(f"internvl2 train: losses {losses}")
    want = {"flash": 2 * c8.n_layers * VL_TRAIN_STEPS,
            "flash_bwd": c8.n_layers * VL_TRAIN_STEPS}
    if counts["flash"] != want["flash"] or counts["flash_bwd"] != \
            want["flash_bwd"] or bwd_sm90 != want["flash_bwd"]:
        raise AssertionError(f"internvl2 train: launches {counts} "
                             f"({bwd_sm90} on flash_bwd_sm90), want {want}")
    step_med = statistics.median(spans[1:])
    print(f"internvl2 train: {c8.n_layers} of {cfg.n_layers} layers at full "
          f"width ({param_count(c8)[0]:,} parameters), {VL_TRAIN_STEPS} "
          f"steps of {tb} x ({Tf} patches + {ts} tokens), remat on, in "
          f"{wall:.1f} s wall; step ms " + " ".join(f"{t * 1e3:.1f}"
                                                    for t in spans)
          + f"; median after the first {step_med * 1e3:.1f} ms, "
          f"{tb * (Tf + ts) / step_med:.0f} positions/s; peak device memory "
          f"{peak / 1e9:.2f} GB; launches a step: flash "
          f"{counts['flash'] // VL_TRAIN_STEPS}, flash_bwd "
          f"{counts['flash_bwd'] // VL_TRAIN_STEPS} (all on flash_bwd_sm90); "
          f"loss {first:.4f} -> {last:.4f}: "
          + " ".join(f"{x:.4f}" for x in losses))
    step = ttrain.make_train_step(c8, opt)
    b = make_lm_batch(TokenStream(c8.vocab_size, seed), VL_TRAIN_STEPS, tb,
                      ts, frontend_tokens=Tf, d_model=c8.d_model,
                      device="cuda")
    bwd_ms = dict.fromkeys(("dkdv_kernel", "dq_kernel", "stats_kernel"))
    busy = profile_once(lambda: step(run["params"], run["opt_state"], b),
                        f"one InternVL2 train step ({c8.n_layers} layers) "
                        f"B={tb}", sums=bwd_ms)
    print(f"internvl2 train: flash_bwd's device time a step "
          f"{sum(bwd_ms.values()):.1f} ms of {busy:.1f} busy ("
          f"{sum(bwd_ms.values()) / busy:.3f}; "
          + ", ".join(f"{k} {v:.1f}" for k, v in bwd_ms.items())
          + f"); idle share against the median unprofiled step "
          f"{1 - busy / (step_med * 1e3):.3f}")
    del run, step, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"serving": serve_launches, "train": want["flash"],
            "train_bwd": want["flash_bwd"]}


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


def profile_sweep(model, data, state, plain_wall, label, top=12):
    """One more sweep from ``state`` under torch.profiler: prints the
    device's idle share and device time by operation and by kernel;
    returns the profiler's key averages."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import gibbs_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gibbs_step(model, data, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    if not 0 < busy <= wall:
        raise AssertionError(f"{label}: device busy {busy:.3f} ms in a "
                             f"sweep of {wall:.3f} ms wall")
    # the profiler slows the host, not the kernels: the busy time set
    # against the unprofiled sweeps' wall is the share without it
    print(f"{label}: one sweep {wall:.1f} ms wall (profiler on), device "
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
    for e in ops_[:top]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key}")
    print("  by kernel:")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    return stats


def phase_profile(sess, res, sweep_ms):
    """One more sweep of the slice under torch.profiler; the sweep runs
    no gather (gram and the gathered sddmm read their rows in their
    loads) and no mul_ or add_ over a Gram buffer."""
    stats = profile_sweep(sess.model, sess.data, res.state,
                          statistics.median(sweep_ms[1:]), "profile")
    counts = {e.key: e.count for e in stats}
    largest = {k: max((e.device_time_total / 1e3 for e in stats
                       if e.key == k), default=0.0)
               for k in ("aten::mul_", "aten::add_")}
    print(f"  gathers: aten::index_select x"
          f"{counts.get('aten::index_select', 0)}; "
          + ", ".join(f"{k} x{counts.get(k, 0)}, {v:.3f} ms in all"
                      for k, v in largest.items()))
    if counts.get("aten::index_select", 0) != 0:
        raise AssertionError(f"profile: {counts.get('aten::index_select')} "
                             "index_select in a sweep, want none")


def header(text: str) -> None:
    """A phase's header line, with the seconds since the script began."""
    print(f"{text} [{time.perf_counter() - T0:.0f} s]", flush=True)


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
            or not (ROOT / PREVIOUS_GRAM).is_file() \
            or not (ROOT / PREVIOUS_SDDMM).is_file():
        print("chip_smoke: run it from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "scripts_dev"))

    header("== card")
    phase_card()
    header(f"== data: {COMPOUNDS} compounds x 8192 proteins, seed "
           f"{args.seed}")
    t0 = time.perf_counter()
    train, test = slice_data(COMPOUNDS, args.seed, "cuda")
    print(f"data: {int(train.nnz)} training entries, {test[0].size} "
          f"test entries, row T={train.rows.max_nnz}, col "
          f"T={train.cols.max_nnz}, {time.perf_counter() - t0:.1f} s")
    header("== kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entries = phase_kernels(train, gen)
    header("== golden chain")
    phase_golden()
    header("== slice")
    burnin, nsamples = SWEEPS
    sess, res, counts, sweep_ms = phase_slice(train, test, burnin,
                                              nsamples, args.seed)
    # the run's peak: run_timed reset the statistics before it
    fp32 = {"ms": statistics.median(sweep_ms[1:]),
            "peak": torch.cuda.max_memory_allocated(),
            "rmse_test": res.rmse_test}
    header("== profile")
    phase_profile(sess, res, sweep_ms)
    del sess, res
    header("== witness: the test predictions where the model is well posed")
    fp32["witness"] = phase_witness(train, test, args.seed)
    torch.cuda.empty_cache()
    header("== bf16_gather: the bf16 kernels, the slice, the witness and "
           "probit with ModelBuilder(bf16_gather=True)")
    bf16, bf16_counts = phase_bf16(train, test, args.seed, gen, fp32)
    torch.cuda.empty_cache()
    header("== serving: store, PredictSession, RecommendServer, topk_score")
    topk, topk16 = phase_serving(train, test, args.seed, gen)
    torch.cuda.empty_cache()
    header("== macau: side information, store, predict_new, cold start")
    phase_macau(train, args.seed)
    torch.cuda.empty_cache()
    header("== probit: binary activities through probit noise")
    phase_probit(train, test, args.seed)
    del train, test
    torch.cuda.empty_cache()
    header("== dense: one fully observed block, the shared-Gram path")
    phase_dense(args.seed)
    header("== gfa: spike-and-slab loadings over dense views")
    phase_gfa(args.seed)
    header("== chains: two chains, each bitwise its single-chain run")
    phase_chains(args.seed)
    torch.cuda.empty_cache()
    header("== sessions: two chains, store, resume, reload, serve, trace, "
           "GFASession")
    phase_sessions(args.seed)
    header("== distributed: the sweep over torch.distributed, eager and "
           "ring")
    dist_launches = phase_distributed(args.seed)
    torch.cuda.empty_cache()
    header("== lm: flash, Qwen3-4B forward, generate, BatchedServer")
    flash = phase_lm(args.seed, phase_flash(gen))
    torch.cuda.empty_cache()
    header("== train: the LSE forward, flash_bwd, SmolLM-135M training, "
           "resume")
    bwd, bwd_mla = phase_flash_bwd(gen)
    bwd, flash["train_launches"] = phase_train(args.seed, bwd)
    flash["train_launches_per_step"] = flash["train_launches"] \
        // TRAIN_STEPS
    flash["lse_max_abs_err"] = bwd.pop("lse_max_abs_err")
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               bwd.pop("flash_max_abs_err"))
    flash["note"] = ("on the training path both designs also write each "
                     "row's log-sum-exp for flash_bwd; launches count the "
                     "lm phase, train_launches the train phase")
    gc.collect()
    torch.cuda.empty_cache()
    header("== train dp: SmolLM-135M through make_sharded_train_step("
           "variant='dponly'), NCCL ranks and two gloo ranks on one card, "
           "restart")
    flash["dp_train_launches"], bwd["dp_train_launches"], dp = \
        phase_train_dp(args.seed)
    bwd["dp_train"] = dp
    flash["note"] += (", dp_train_launches the train dp phase's (per rank: "
                      "the NCCL world's rank 0 and each gloo rank)")
    gc.collect()
    torch.cuda.empty_cache()
    header("== deepseek: the two-width flash, DeepSeek-V2-Lite forward, "
           "generate, BatchedServer")
    flash_mla = phase_lm(args.seed, phase_flash_mla(gen), arch=DS_ARCH,
                         agree_min=None)
    gc.collect()
    torch.cuda.empty_cache()
    phase_decode_fp32(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    header(f"== train mla: DeepSeek-V2-Lite at full width, "
           f"{MLA_TRAIN_LAYERS} layers, through the two-width flash "
           "backward")
    bwd_mla = phase_train_mla(args.seed, bwd_mla)
    gc.collect()
    torch.cuda.empty_cache()
    header("== ssm: Mamba2-130M forward, generate, BatchedServer, fp32 "
           "decode, training, restart")
    flash["ssm_launches"] = phase_ssm(args.seed)
    header(f"== jamba: the windowed flash, Jamba's period ({JAMBA_LAYERS} "
           "layers, window 4,096) forward, generate, BatchedServer, the ring "
           "buffer")
    flash["jamba_launches"], flash["window"] = phase_jamba(args.seed, gen)
    flash["note"] += (", ssm_launches and jamba_launches the ssm and jamba "
                      "phases (window: the windowed call at Jamba's shape)")
    gc.collect()
    torch.cuda.empty_cache()
    header("== whisper: the non-causal flash and flash_bwd, Whisper-medium "
           "forward, decode, fp32 checks, training, restart")
    flash_nc, bwd_nc = phase_whisper(args.seed, gen)
    gc.collect()
    torch.cuda.empty_cache()
    header("== internvl2: InternVL2-2B forward with patches, generate, "
           f"BatchedServer, fp32 check, training ({VL_TRAIN_LAYERS} layers)")
    vl = phase_internvl2(args.seed, gen)
    flash["internvl2_launches"] = vl["serving"] + vl["train"]
    bwd["internvl2_launches"] = vl["train_bwd"]
    flash["note"] += (", internvl2_launches the internvl2 phase's serving "
                      "and training (hd 128, causal)")

    for name, entry in entries.items():
        entry["launches"] = counts[name]
    # the bf16 entries' launches on the bf16_gather paths: the slice's
    # run, and probit's for the mixed padded entry; the pre-gathered
    # bf16 sddmm is the reference's entry, which the port's sweep
    # replaces by the gathered one
    for name, run in (("gram_gathered_bf16", "slice"),
                      ("sddmm_gathered_bf16", "slice"),
                      ("sddmm_padded_mixed", "probit")):
        bf16[name]["launches"] = bf16_counts[run][name]
        bf16[name]["launches_path"] = f"bf16_gather {run}"
    bf16["sddmm_bf16"]["launches"] = bf16_counts["slice"]["sddmm_bf16"]
    bf16["sddmm_bf16"]["launches_note"] = (
        "the reference's pre-gathered entry; the port's sweep runs "
        "sddmm_gathered_bf16 in its place")
    # the same kernels' launches in the distributed phase's runs (slice
    # eager and ring, probit eager, the bf16 slice eager and ring; 4
    # sweeps each), apart from the main path's
    for name in ("gram", "sddmm_gathered"):
        entries[name]["distributed_launches"] = {
            run: c[name] for run, c in dist_launches.items()
            if "bf16" not in run}
    # (the bf16 runs' residuals go through the padded bf16 x bf16 entry,
    # which the sddmm_padded_mixed entry holds beside the mixed one)
    for name, key in (("gram_gathered_bf16", "gram_gathered_bf16"),
                      ("sddmm_padded_mixed", "sddmm_padded_bf16")):
        bf16[name]["distributed_launches"] = {
            run: c[key] for run, c in dist_launches.items() if "bf16" in run}
    bf16["sddmm_padded_mixed"]["distributed_entry"] = "sddmm_padded_bf16"
    header("== done: every phase passed")
    print(json.dumps({"kernels": [entries["gram"], entries["sddmm"],
                                  entries["sddmm_gathered"], topk,
                                  bf16["gram_gathered_bf16"],
                                  bf16["sddmm_bf16"],
                                  bf16["sddmm_gathered_bf16"],
                                  bf16["sddmm_padded_mixed"], topk16,
                                  flash, bwd, flash_mla, bwd_mla,
                                  flash_nc, bwd_nc]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
