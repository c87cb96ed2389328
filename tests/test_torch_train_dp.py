"""The port's data-parallel training step (``launch/train.py``'s
``make_sharded_train_step``, the reference's ``dponly`` variant: the
batch split over the ranks, replicated fp32 parameters, ZeRO-1 AdamW
moments) against the single-process step of the port and the
reference's step on the global batch, on the CPU.

Worlds of ranks are processes (``repro_torch.runtime.run_world``): gloo,
one thread a rank, one module fixture a world size, each world running
every case.  The ranks import ``repro_torch`` alone (each asserts that
no ``jax`` module is loaded); the initial weights are the reference's
``init_model(PRNGKey(0))`` params converted in this process
(``test_torch_train._port_model``) and handed over by file, and the
ranks' results come back as ``.npz``.

The cases are the smoke configs of the four models the reference runs
under ``dponly`` (``repro/launch/dryrun.py``'s ``BEST_VARIANT``):
SmolLM-135M, Mamba2-130M, Whisper-medium (with ``enc_frames``) and
InternVL2-2B (with ``frontend`` patches), each in fp32 at one
microbatch; SmolLM also in bf16, and in fp32 under ``dponly,micro2``.
Each takes three steps of a global batch of 8 x 16 whose labels are
masked unevenly across the ranks (``_mask``).  Held:

* a world of 1: bitwise ``make_train_step`` (every weight 1.0, the
  all-reduce of one rank the identity);
* worlds of 2 and 4: the reference's jitted ``make_train_step`` on the
  global batch, under ``test_torch_train.py``'s rules (fp32: losses
  rtol 1e-5, parameters ``FP32_TOL``; bf16: losses rtol 1e-3,
  parameters within 2 lr x steps); every rank's parameters bitwise
  equal after every step; each rank's ZeRO-1 update bitwise an
  unsharded ``adamw_update`` of a copy fed the same all-reduced
  gradients; a step's collectives at their stated count;
* the plan's moment bytes on a rank within one leaf of 1/N of the whole;
* ``train(variant="dponly")``: a restart from its checkpoint in a world
  of 2, after a lost device in that world, and in one process, bitwise,
  its saves gathering the moments to rank 0 in chunks of ``SAVE_CHUNK``
  elements; ``n_micro`` beside a variant refused;
* ``baseline``, ``ep``, a ``dponly`` that the batch reduces to baseline,
  an unknown flag and an MoE config refused with ValueError (world of 4);
* ``effective_variant``, ``batch_shard`` and the moment rule against the
  reference's ``specs`` on the same shapes, in this process;
* on a card (``cuda`` marker): an NCCL world of one, SmolLM's smoke
  config in bf16, bitwise ``make_train_step`` through the flash kernels.
"""
import concurrent.futures
import copy
import dataclasses
import functools
import hashlib
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.runtime import run_world
from torch_threads import _one_thread  # noqa: F401 (autouse)

HERE = Path(__file__).resolve().parent

# (arch, dtype, variant)
CASES = [(a, "float32", "dponly") for a in
         ("smollm_135m", "mamba2_130m", "whisper_medium", "internvl2_2b")] \
    + [("smollm_135m", "bfloat16", "dponly"),
       ("smollm_135m", "float32", "dponly,micro2")]
IDS = ["smollm", "mamba2", "whisper", "internvl2", "smollm-bf16",
       "smollm-micro2"]
BATCH, SEQ, STEPS = 8, 16, 3
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)   # test_torch_train's
FP32_TOL = dict(rtol=1e-4, atol=1e-5)
ALIGN = 128            # launch/train.py's flat-buffer alignment
RESTART = dict(steps=6, batch=4, seq=16, save_every=2, fail_at=3)
SAVE_CHUNK = 4096      # elements: smaller than the smoke configs' largest
REFUSED = {"baseline": "baseline", "ep": "dponly,ep",
           "reduced": "dponly", "unknown": "dponly,bf16scores",
           "moe": "dponly"}


def _no_jax():
    assert "jax" not in sys.modules and "repro" not in sys.modules, \
        "a rank imported jax or the reference package"


def _cfg(tcfg, arch, dtype):
    return dataclasses.replace(tcfg.get_smoke(arch), dtype=dtype)


def _mask(labels):
    """Uneven masks over the ranks: the first five labels of row 0 and
    one of row 5 (numpy array or tensor, in place)."""
    labels[0, :5] = -1
    labels[5, 3] = -1
    return labels


def _batch(cfg, step, batch=BATCH, seq=SEQ, device="cpu"):
    from repro_torch.data import TokenStream, make_lm_batch
    b = make_lm_batch(TokenStream(cfg.vocab_size, seed=2), step, batch,
                      seq, frontend_tokens=cfg.n_frontend_tokens,
                      d_model=cfg.d_model,
                      enc_frames=cfg.encoder_frames
                      if cfg.is_encoder_decoder else 0, device=device)
    _mask(b["labels"])
    return b


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _case_tag(i):
    return f"c{i}"


# ---------------------------------------------------------------------------
# what the ranks run (repro_torch only)
# ---------------------------------------------------------------------------

def _mesh(world, device_type="cpu"):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=("data",))


def _loaded(init_models, cfg, i):
    from repro_torch.models import init_model
    model = init_model(cfg, 0, device="cpu", train=True)
    saved = torch.load(Path(init_models) / f"{_case_tag(i)}.pt")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return model


def _run_case(rank, world, rec, tag, cfg, variant, model):
    """Three steps of the sharded step; beside it an unsharded copy fed
    the same all-reduced gradients, and at one rank the single-process
    ``make_train_step`` on the same global batches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.specs import batch_shard
    from repro_torch.launch.train import (make_sharded_train_step,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    opt = AdamWConfig(**OPT)
    step, plan = make_sharded_train_step(
        cfg, opt, _mesh(world), ShapeSpec("t", SEQ, BATCH, "train"),
        variant=variant)
    assert step.rank == rank and step.world_size == world
    ost = step.init_opt_state(model)
    plain = {n: p.detach().clone() for n, p in model.named_parameters()}
    plain_state = adamw_init(plain)
    if world == 1:
        single = copy.deepcopy(model)
        single_state = adamw_init(dict(single.named_parameters()))
        single_step = make_train_step(cfg, opt, n_micro=step.n_micro)
    rec[f"{tag}_n_micro"] = step.n_micro
    rec[f"{tag}_moment_elems"] = sum(int(x.numel()) for x in ost.m.values())
    for s in range(STEPS):
        b = _batch(cfg, s)
        local = batch_shard(b, rank, world, step.n_micro)
        if world == 1:
            # the whole step, as train() calls it
            model, ost, m = step(model, ost, local)
            single, single_state, sm = single_step(single, single_state, b)
            for k in ("loss", "grad_norm", "lr"):
                rec[f"{tag}_s{s}_single_{k}"] = sm[k].numpy()
            rec[f"{tag}_s{s}_single"] = _digest(
                list(single.parameters())
                + [single_state.m[n] for n in plan.shapes]
                + [single_state.v[n] for n in plan.shapes])
        else:
            step.reset_census()
            loss, grads = step.gradients(model, local)
            _, plain_state, _ = adamw_update(opt, plain, grads, plain_state)
            model, ost, m = step.apply(model, ost, grads)
            m = {"loss": loss, **m}
            named = dict(model.named_parameters())
            rec[f"{tag}_s{s}_zero1"] = all(
                torch.equal(named[n], plain[n])
                and torch.equal(ost.m[n], plan.shard(n, plain_state.m[n],
                                                     rank))
                and torch.equal(ost.v[n], plan.shard(n, plain_state.v[n],
                                                     rank))
                for n in plan.shapes) and int(ost.step) == int(
                    plain_state.step)
        for k in ("loss", "grad_norm", "lr"):
            rec[f"{tag}_s{s}_{k}"] = m[k].numpy()
        c = step.census()
        for k in ("all_reduces", "all_gathers", "reduce_elems",
                  "gather_elems", "wire_bytes"):
            rec[f"{tag}_s{s}_census_{k}"] = c[k]
        rec[f"{tag}_s{s}_dtypes"] = ",".join(c["dtypes"])
        rec[f"{tag}_s{s}_params"] = _digest(model.parameters())
        if world == 1:
            rec[f"{tag}_s{s}_state"] = _digest(
                list(model.parameters()) + [ost.m[n] for n in plan.shapes]
                + [ost.v[n] for n in plan.shapes])
    for n, p in model.named_parameters():
        rec[f"{tag}_p_{n}"] = p.detach().numpy()


def _restart_kw():
    from repro_torch.optim import AdamWConfig
    return dict(steps=RESTART["steps"], batch=RESTART["batch"],
                seq=RESTART["seq"], log_every=0, device="cpu",
                opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=RESTART["steps"]))


def _run_restarts(rank, world, rec, out):
    """``train(variant="dponly")`` whole, resumed from its checkpoint,
    and restarted after a lost device; the world's checkpoint at step 4
    is copied for the one-process resume, with the state it holds."""
    import torch.distributed as dist
    from repro_torch import configs as tcfg
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.train import train
    from repro_torch.runtime import FailureSim
    cfg = _cfg(tcfg, "smollm_135m", "float32")
    kw = dict(_restart_kw(), variant="dponly")
    # a save gathers the moments in chunks of SAVE_CHUNK elements (a
    # larger moment alone), as a full-size model's do
    ttrain._SAVE_CHUNK = SAVE_CHUNK
    save = RESTART["save_every"]

    def state(res):
        return list(res["params"].parameters()) \
            + list(res["opt_state"].m.values()) \
            + list(res["opt_state"].v.values())

    whole = train(cfg, **kw)
    rec["whole_losses"] = np.asarray(whole["losses"])
    rec["whole_state"] = _digest(state(whole))
    first = train(cfg, **dict(kw, steps=4), ckpt_dir=str(out / "ckpt"),
                  save_every=save)
    full = first["step"].host_opt_state(first["opt_state"])
    if rank == 0:
        shutil.copytree(out / "ckpt", out / "ckpt_at_4")
        np.savez(out / "state_at_4.npz",
                 **{f"p_{n}": p.detach().numpy()
                    for n, p in first["params"].named_parameters()},
                 **{f"m_{n}": x.numpy() for n, x in full.m.items()},
                 **{f"v_{n}": x.numpy() for n, x in full.v.items()})
    dist.barrier()
    rest = train(cfg, **kw, ckpt_dir=str(out / "ckpt"), save_every=save)
    rec["rest_losses"] = np.asarray(rest["losses"])
    rec["rest_state"] = _digest(state(rest))
    sim = FailureSim(fail_at=[RESTART["fail_at"]])
    lost = train(cfg, **kw, ckpt_dir=str(out / "ckpt_lost"),
                 save_every=save, failure_sim=sim)
    rec["lost_failures"] = sim.failures
    rec["lost_losses"] = np.asarray(lost["losses"])
    rec["lost_state"] = _digest(state(lost))


def _refusals(world, rec):
    from repro_torch import configs as tcfg
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import make_sharded_train_step
    from repro_torch.optim import AdamWConfig
    for name, variant in REFUSED.items():
        arch = "deepseek_v2_lite_16b" if name == "moe" else "smollm_135m"
        batch = 6 if name == "reduced" else BATCH
        try:
            make_sharded_train_step(
                _cfg(tcfg, arch, "float32"), AdamWConfig(), _mesh(world),
                ShapeSpec("t", SEQ, batch, "train"), variant=variant)
        except ValueError as e:
            rec[f"refused_{name}"] = str(e)


def rank_world(rank, world, out, init_models):
    """Every case; in a world of 2 the restarts, in a world of 4 the
    refusals."""
    from repro_torch import configs as tcfg
    out = Path(out)
    rec = {}
    for i, (arch, dtype, variant) in enumerate(CASES):
        cfg = _cfg(tcfg, arch, dtype)
        _run_case(rank, world, rec, _case_tag(i), cfg, variant,
                  _loaded(init_models, cfg, i))
    if world == 2:
        _run_restarts(rank, world, rec, out)
    if world == 4:
        _refusals(world, rec)
    np.savez(out / f"rank{rank}.npz", **{k: np.asarray(v)
                                         for k, v in rec.items()})
    _no_jax()


# ---------------------------------------------------------------------------
# the worlds (module fixtures), and the references beside them
# ---------------------------------------------------------------------------

def _init_models(base):
    """The reference's initial weights of every case, as the port's
    parameters by name, in files the ranks load."""
    import test_torch_train as tt
    d = Path(base) / "init"
    d.mkdir()
    for i, (arch, dtype, _) in enumerate(CASES):
        model = tt._port_model(arch, dtype)
        torch.save({n: p.detach() for n, p in model.named_parameters()},
                   d / f"{_case_tag(i)}.pt")
    return str(d)


def _world(base, init, size):
    out = base / f"out{size}"
    out.mkdir()
    run_world("test_torch_train_dp:rank_world", size,
              workdir=base / f"world{size}", args=(str(out), init),
              extra_paths=[str(HERE)], timeout_s=600)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(size)]


@pytest.fixture(scope="module")
def all_worlds(tmp_path_factory):
    """The worlds of 1, 2 and 4 ranks, run side by side while this
    process runs the reference's steps: {size: (out dir, ranks' records)}."""
    base = tmp_path_factory.mktemp("worlds")
    init = _init_models(base)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = {n: pool.submit(_world, base, init, n) for n in (1, 2, 4)}
        for i in range(len(CASES)):
            _reference_run(i)
        return {n: f.result() for n, f in runs.items()}


@pytest.fixture(scope="module")
def world1(all_worlds):
    return all_worlds[1]


@pytest.fixture(scope="module")
def world2(all_worlds):
    return all_worlds[2]


@pytest.fixture(scope="module")
def world4(all_worlds):
    return all_worlds[4]


@pytest.fixture
def worlds(request):
    return request.getfixturevalue(request.param)


@functools.lru_cache(maxsize=None)
def _reference_run(i):
    """The reference's jitted ``make_train_step`` on the global batches:
    (losses, final params as numpy)."""
    import jax
    import jax.numpy as jnp
    import test_torch_train as tt
    from repro.data import TokenStream as JStream
    from repro.data import make_lm_batch as jmake_lm_batch
    from repro.launch.train import make_train_step as jmake_train_step
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as jadamw_init
    arch, dtype, variant = CASES[i]
    jc, _ = tt._cfgs(arch, dtype)
    n_micro = 2 if "micro2" in variant else 1
    params = tt._reference_params(arch, dtype)
    js = JStream(jc.vocab_size, seed=2)
    losses = []
    with jax.threefry_partitionable(False):
        opt = jadamw_init(params)
        step = jax.jit(jmake_train_step(jc, JAdamWConfig(**OPT),
                                        n_micro=n_micro))
        for s in range(STEPS):
            jb = jmake_lm_batch(
                js, s, BATCH, SEQ, frontend_tokens=jc.n_frontend_tokens,
                d_model=jc.d_model,
                enc_frames=jc.encoder_frames if jc.is_encoder_decoder
                else 0)
            jb["labels"] = jnp.asarray(_mask(np.array(jb["labels"])))
            params, opt, m = step(params, opt, jb)
            losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_world_of_one_is_make_train_step_bitwise(world1, i):
    _, (rank,) = world1
    tag = _case_tag(i)
    for s in range(STEPS):
        assert rank[f"{tag}_s{s}_state"] == rank[f"{tag}_s{s}_single"], s
        for k in ("loss", "grad_norm", "lr"):
            assert rank[f"{tag}_s{s}_{k}"].tobytes() == \
                rank[f"{tag}_s{s}_single_{k}"].tobytes(), (s, k)


WORLD_CASES = [(w, i) for w in ("world2", "world4")
               for i in range(len(CASES))]
WORLD_IDS = [f"{w}-{IDS[i]}" for w, i in WORLD_CASES]


@pytest.mark.parametrize("worlds,i", WORLD_CASES, ids=WORLD_IDS,
                         indirect=["worlds"])
def test_matches_reference_global_batch_step(worlds, i):
    """Every rank's losses and final parameters against the reference's
    step on the global batch: fp32 losses rtol 1e-5 and parameters at
    ``FP32_TOL``; bf16 losses rtol 1e-3 and parameters within 2 lr x
    steps (``test_torch_train.py``'s rules)."""
    from repro_torch import configs as tcfg
    from repro_torch.convert import reference_leaf
    _, ranks = worlds
    arch, dtype, _ = CASES[i]
    cfg = _cfg(tcfg, arch, dtype)
    want_losses, want = _reference_run(i)
    tag = _case_tag(i)
    for rank in ranks:
        got = [float(rank[f"{tag}_s{s}_loss"]) for s in range(STEPS)]
        np.testing.assert_allclose(
            got, want_losses, rtol=1e-5 if dtype == "float32" else 1e-3)
        for key in rank:
            if not key.startswith(f"{tag}_p_"):
                continue
            name = key[len(f"{tag}_p_"):]
            ref = reference_leaf(want, name, cfg)
            if dtype == "float32":
                np.testing.assert_allclose(rank[key], ref, **FP32_TOL,
                                           err_msg=name)
            else:
                assert np.abs(rank[key] - ref).max() <= \
                    2 * OPT["lr"] * STEPS, name


@pytest.mark.parametrize("worlds,i", WORLD_CASES, ids=WORLD_IDS,
                         indirect=["worlds"])
def test_ranks_hold_the_same_parameters_after_every_step(worlds, i):
    _, ranks = worlds
    tag = _case_tag(i)
    for s in range(STEPS):
        assert len({r[f"{tag}_s{s}_params"].item() for r in ranks}) == 1
        for k in ("loss", "grad_norm", "lr"):
            assert len({r[f"{tag}_s{s}_{k}"].tobytes() for r in ranks}) \
                == 1, (s, k)


@pytest.mark.parametrize("worlds,i", WORLD_CASES, ids=WORLD_IDS,
                         indirect=["worlds"])
def test_zero1_update_is_the_unsharded_update_bitwise(worlds, i):
    """Each rank's parameters and moment slices after each step are
    bitwise those of ``adamw_update`` on an unsharded copy fed the same
    all-reduced gradients."""
    _, ranks = worlds
    for rank in ranks:
        assert all(bool(rank[f"{_case_tag(i)}_s{s}_zero1"])
                   for s in range(STEPS))


def _plan(arch, dtype, world):
    from repro_torch import configs as tcfg
    from repro_torch.launch.specs import train_state_plan
    from repro_torch.models import init_model
    model = init_model(_cfg(tcfg, arch, dtype), device="meta", train=True)
    return train_state_plan(dict(model.named_parameters()), world)


@pytest.mark.parametrize("worlds,i", WORLD_CASES + [
    ("world1", i) for i in range(len(CASES))],
    ids=WORLD_IDS + [f"world1-{n}" for n in IDS], indirect=["worlds"])
def test_step_census_is_its_stated_count(worlds, i):
    """A step: one all-reduce of the microbatches' label counts, one of
    the flat fp32 gradients (each leaf padded to ``ALIGN`` elements)
    with the loss, and one all-gather of this rank's updated parameter
    slices."""
    _, ranks = worlds
    arch, dtype, variant = CASES[i]
    plan = _plan(arch, dtype, len(ranks))
    n_micro = 2 if "micro2" in variant else 1
    flat = sum(-(-int(np.prod(s)) // ALIGN) * ALIGN
               for s in plan.shapes.values())
    gathered = sum(int(np.prod(plan.shard_shape(n))) for n in plan.shapes
                   if plan.moment_dims[n] is not None)
    want = {"all_reduces": 2, "all_gathers": 1,
            "reduce_elems": n_micro + flat + 1, "gather_elems": gathered}
    want["wire_bytes"] = 4 * (want["reduce_elems"] + gathered)
    tag = _case_tag(i)
    for rank in ranks:
        assert int(rank[f"{tag}_n_micro"]) == n_micro
        for s in range(STEPS):
            got = {k: int(rank[f"{tag}_s{s}_census_{k}"]) for k in want}
            assert got == want and rank[f"{tag}_s{s}_dtypes"] == "f32"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_130m",
                                  "whisper_medium", "internvl2_2b"])
def test_moment_bytes_per_rank_are_a_share_of_the_whole(arch, world):
    """A rank's fp32 moments are 1/N of the whole, give or take the
    leaves the rule replicates: within one leaf (the largest)."""
    plan = _plan(arch, "float32", world)
    largest = 2 * 4 * max(int(np.prod(s)) for s in plan.shapes.values())
    share = plan.full_moment_bytes() / world
    assert share <= plan.moment_bytes() <= share + largest
    assert sum(d is not None for d in plan.moment_dims.values()) \
        > len(plan.shapes) // 2


def test_ranks_allocate_their_moment_shards(world2, world4):
    for world in (world2, world4):
        _, ranks = world
        plan = _plan("smollm_135m", "float32", len(ranks))
        for rank in ranks:
            assert int(rank["c0_moment_elems"]) * 8 == plan.moment_bytes()


def test_restart_in_a_world_of_two_is_bitwise(world2):
    """``train(variant="dponly")`` resumed from its own checkpoint at
    step 4, and restarted from step 2's after a lost device at step 3,
    ends on the uninterrupted run's bits on every rank."""
    _, ranks = world2
    for rank in ranks:
        whole = rank["whole_losses"]
        assert len(whole) == RESTART["steps"]
        assert rank["rest_losses"].tobytes() == whole[4:].tobytes()
        assert rank["rest_state"] == rank["whole_state"]
        assert int(rank["lost_failures"]) == 1
        assert rank["lost_losses"].tobytes() == np.concatenate(
            [whole[:3], whole[2:]]).tobytes()
        assert rank["lost_state"] == rank["whole_state"]
    assert ranks[0]["whole_losses"].tobytes() == \
        ranks[1]["whole_losses"].tobytes()


def test_world_checkpoint_resumes_in_one_process_bitwise(world2, tmp_path):
    """The world of 2's checkpoint at step 4 (rank 0's, the
    single-process layout with unsharded moments) resumes in one
    process: steps 4 and 5 there are bitwise ``make_train_step`` from
    the world's state at step 4."""
    from repro_torch import configs as tcfg
    from repro_torch.data import TokenStream, make_lm_batch
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import init_model
    from repro_torch.optim import OptState
    out, _ = world2
    cfg = _cfg(tcfg, "smollm_135m", "float32")
    kw = _restart_kw()
    shutil.copytree(out / "ckpt_at_4", tmp_path / "ckpt")
    one = train(cfg, **kw, ckpt_dir=str(tmp_path / "ckpt"),
                save_every=RESTART["save_every"])
    assert one["final_step"] == RESTART["steps"] and len(one["losses"]) == 2

    saved = np.load(out / "state_at_4.npz")
    model = init_model(cfg, 0, device="cpu", train=True)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(saved[f"p_{n}"]))
    names = [n for n, _ in model.named_parameters()]
    ost = OptState({n: torch.from_numpy(saved[f"m_{n}"]) for n in names},
                   {n: torch.from_numpy(saved[f"v_{n}"]) for n in names},
                   torch.tensor(4, dtype=torch.int32))
    step = make_train_step(cfg, kw["opt_cfg"])
    stream = TokenStream(cfg.vocab_size, seed=0)     # train()'s
    losses = []
    for s in (4, 5):
        model, ost, m = step(model, ost, make_lm_batch(
            stream, s, RESTART["batch"], RESTART["seq"], device="cpu"))
        losses.append(float(m["loss"]))
    assert one["losses"] == losses
    got = dict(one["params"].named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(got[n], p), n
        assert torch.equal(one["opt_state"].m[n], ost.m[n]), n
        assert torch.equal(one["opt_state"].v[n], ost.v[n]), n


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_variants_and_configs_name_roadmap_a11(world4, name):
    _, ranks = world4
    msg = str(ranks[0][f"refused_{name}"])
    if name == "unknown":
        assert "bf16scores" in msg
    else:
        assert "ROADMAP A11" in msg
    assert {"ep": "expert parallelism", "moe": "MoE",
            "reduced": "does not divide the world",
            "baseline": "is not 'dponly'"}.get(name, "") in msg


def test_train_refuses_n_micro_beside_a_variant():
    """A data-parallel ``train`` takes its microbatches from the
    variant's ``micro<k>`` flag only; ``n_micro`` beside a variant raises
    (before any process group is needed) and names the flag."""
    from repro_torch import configs as tcfg
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match="'dponly,micro2'"):
        train(_cfg(tcfg, "smollm_135m", "float32"), steps=1, batch=4,
              seq=16, n_micro=2, device="cpu", variant="dponly")


# ---------------------------------------------------------------------------
# the layout against the reference's specs, in this process
# ---------------------------------------------------------------------------

def _abstract_mesh(world):
    from jax.sharding import AbstractMesh
    return AbstractMesh((world // 2, 2) if world > 2 else (world,),
                        ("data", "model") if world > 2 else ("data",))


@pytest.mark.parametrize("variant,batch,world", [
    ("dponly", 8, 4), ("dponly", 6, 4), ("dponly", 6, 2),
    ("dponly,flashvjp", 8, 2), ("dponly,micro2", 12, 8),
    ("baseline", 8, 4), ("", 8, 2), ("noremat", 8, 1)])
def test_effective_variant_is_the_references(variant, batch, world):
    from repro.launch import specs as jspecs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.specs import effective_variant
    from jax.sharding import AbstractMesh
    mesh = AbstractMesh((world,), ("data",))
    shape = ShapeSpec("t", SEQ, batch, "train")
    assert effective_variant(variant, shape, world) == \
        jspecs.effective_variant(variant, shape, mesh)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_batch_shard_is_the_references_rule(world, n_micro):
    """Under ``dponly`` the reference shards every batch leaf's first
    axis over all mesh axes (``batch_shardings``: device r of the
    flattened mesh holds block r) and splits the global batch into
    ``n_micro`` microbatches by a reshape; rank r's rows of global
    microbatch i are block r of microbatch i."""
    from repro import configs as jcfg
    from repro.launch import specs as jspecs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.specs import batch_shard
    cfg = jcfg.get_smoke("internvl2_2b")
    B = 8
    mesh = _abstract_mesh(world)
    sh = jspecs.batch_shardings(cfg, ShapeSpec("t", SEQ, B, "train"), mesh,
                                variant="dponly")
    for spec in (s.spec for s in sh.values()):
        assert tuple(spec[0] if isinstance(spec[0], tuple)
                     else (spec[0],)) == tuple(mesh.axis_names)
        assert all(p is None for p in spec[1:])
    batch = {"tokens": torch.arange(B * 5).reshape(B, 5),
             "frontend": torch.randn(B, 3, 4)}
    for r in range(world):
        got = batch_shard(batch, r, world, n_micro)
        for k, x in batch.items():
            micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])
            rows = B // n_micro // world
            want = micro[:, r * rows:(r + 1) * rows].reshape(
                -1, *x.shape[1:])
            assert torch.equal(got[k], want), (k, r)
    with pytest.raises(ValueError, match="not a multiple"):
        batch_shard(batch, 0, 3, 1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["smollm_135m", "whisper_medium"])
def test_moment_rule_is_the_references(arch, world):
    """The reference's ``train_state_shardings`` under ``dponly`` on its
    own (scanned) leaves: each moment leaf sharded on the dim the port's
    ``moment_shard_dim`` picks for the same shape, parameters and the
    step replicated."""
    import jax
    from repro import configs as jcfg
    from repro.launch import specs as jspecs
    from repro_torch.launch.specs import moment_shard_dim
    mesh = _abstract_mesh(world)
    cfg = jcfg.get_smoke(arch)
    ps, os_ = jspecs.train_state_shardings(cfg, mesh, variant="dponly")
    params, _ = jspecs.abstract_train_state(cfg)
    assert all(s.spec == jax.sharding.PartitionSpec()
               for s in jax.tree.leaves(ps))
    assert os_.step.spec == jax.sharding.PartitionSpec()
    for x, s in zip(jax.tree.leaves(params), jax.tree.leaves(os_.m)):
        dims = [d for d, a in enumerate(s.spec) if a is not None]
        assert dims == ([] if moment_shard_dim(x.shape, world) is None
                        else [moment_shard_dim(x.shape, world)]), x.shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def rank_cuda(rank, world, out):
    """SmolLM's smoke config in bf16 on this rank's card: three sharded
    steps, each bitwise the single-process step on the same batch."""
    from repro_torch import configs as tcfg
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import (make_sharded_train_step,
                                          make_train_step)
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = tcfg.get_smoke("smollm_135m")
    opt = AdamWConfig(**OPT)
    step, _ = make_sharded_train_step(cfg, opt, _mesh(world, "cuda"),
                                      ShapeSpec("t", SEQ, BATCH, "train"))
    model = init_model(cfg, 0, train=True)
    ost = step.init_opt_state(model)
    single = copy.deepcopy(model)
    sost = adamw_init(dict(single.named_parameters()))
    single_step = make_train_step(cfg, opt)
    for s in range(STEPS):
        b = _batch(cfg, s, device=model.device)
        model, ost, m = step(model, ost, b)
        single, sost, sm = single_step(single, sost, b)
        got, want = dict(model.named_parameters()), \
            dict(single.named_parameters())
        assert all(torch.equal(got[n], want[n])
                   and torch.equal(ost.m[n], sost.m[n])
                   and torch.equal(ost.v[n], sost.v[n]) for n in got), s
        assert torch.equal(m["loss"], sm["loss"]), s
    _no_jax()


@pytest.mark.cuda
def test_nccl_world_of_one_on_the_card_is_make_train_step_bitwise(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    run_world("test_torch_train_dp:rank_cuda", 1, device_type="cuda",
              workdir=tmp_path / "world", args=(str(tmp_path),),
              extra_paths=[str(HERE)], timeout_s=600)
