"""The port's MoE layer and the grok smoke model against the JAX
package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights, carried over by ``convert.lm_params_from_reference``; inputs
come from numpy with a seed.  The reference's dispatch tensors are read
where it computes them, by a stand-in for ``repro.models.moe``'s
``jnp`` that records the two routing einsums and passes every call on.

Tolerances:
* ``apply_moe`` on the same input, fp32 and bf16: the router, gates and
  dispatch are fp32 from the same bits, so the dispatch tensor (which
  token sits in which slot of which expert, and which are dropped) is
  equal exactly and the combine tensor within ``FP32_TOL``; the output
  within ``test_torch_lm.py``'s ``FP32_TOL`` / ``BF16_TOL`` (the expert
  products round to bf16 in both, at places that may differ by an
  ulp); the aux losses rtol 1e-6 (fp32 means of the same values);
* whole models, fp32: logits ``FP32_TOL`` and argmax, the aux sum rtol
  1e-6, and every MoE layer's dispatch equal exactly;
* whole models, bf16: the two packages' attention rounds at other
  places (``test_torch_lm.py`` says where), so a layer's input differs
  by bf16 ulps, and the routing, a step function of it, may send a
  token whose top experts nearly tie to another expert; capacity then
  moves the later tokens of its group.  Such a flip is the function's
  own discontinuity, not the port's: the test counts them (each must
  be a near-tie of the router's fp32 logits, or a later token of a
  group in which one was), and holds at ``BF16_TOL`` every row that
  neither a flip nor an earlier position of its sequence reached; in
  each such row the port's argmax is a maximiser of the reference's
  logits within two bf16 ulps (``_argmax_held``: an argmax share over a
  few dozen rows is a coin toss where two logits tie in bf16);
* ``serve_step`` (a group of the step's B tokens): logits at the same
  tolerances over several steps, a bf16 flip reaching its row's later
  steps;
* serving: tokens equal exactly in fp32 (``test_torch_lm_serve.py``);
* ``loss_fn`` and its gradients in fp32: ``test_torch_train.py``'s
  ``FP32_TOL``, remat on and off the same bits.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import test_torch_lm as lm
from repro import configs as jcfg
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch import serve as jserve
from repro.models import (forward as jforward, init_model as jinit,
                          init_serve_cache as jcache, loss_fn as jloss_fn,
                          serve_step as jstep)
from repro_torch.convert import lm_params_from_reference, reference_leaf
from repro_torch.data import TokenStream, make_lm_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import (forward, init_model, init_serve_cache,
                                loss_fn, serve_step)
from repro_torch.models import moe as tmoe
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "grok_1_314b"
DTYPES = lm.DTYPES
# a MoE layer of each smoke config: grok (no shared expert), deepseek
# (one shared expert, and a dense prologue layer before the stack)
MOE_ARCHS = ["grok_1_314b", "deepseek_v2_lite_16b"]
AUX_RTOL = 1e-6
# a bf16 flip is a near-tie when two of the token's top k + 1 experts'
# logits are closer than a relative change of 2^-5 (a few bf16 ulps) of
# every router input could move them apart: |l1 - l2| <= 2^-5 sum_d
# |x_d| |w_d,e1 - w_d,e2|
NEAR_TIE = 2.0 ** -5


class _RecordingJnp:
    """``jax.numpy`` with ``einsum`` recording the reference's dispatch
    and combine tensors."""

    def __init__(self, record):
        self._record = record

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        out = jnp.einsum(spec, *operands, **kw)
        if spec in ("ngke,ngkec->ngec", "ngk,ngke,ngkec->ngec"):
            self._record.setdefault(spec, []).append(np.asarray(out))
        return out


@contextlib.contextmanager
def reference_routing():
    """{"dispatch": [...], "combine": [...]} of every ``apply_moe`` the
    reference runs inside, in order (under ``jax.disable_jit`` so that
    the scanned stack gives concrete arrays)."""
    rec = {}
    saved = jmoe.jnp
    jmoe.jnp = _RecordingJnp(rec)
    out = {}
    try:
        with jax.disable_jit():
            yield out
    finally:
        jmoe.jnp = saved
        out["dispatch"] = rec.get("ngke,ngkec->ngec", [])
        out["combine"] = rec.get("ngk,ngke,ngkec->ngec", [])


@contextlib.contextmanager
def port_routing():
    """The port's ``moe.route`` results, in order, each with its router
    weight ``w`` and grouped input ``xt``."""
    got = []
    orig = tmoe.route

    def spy(router_w, cfg, xt):
        r = orig(router_w, cfg, xt)
        got.append(dict(r, w=router_w, xt=xt))
        return r

    tmoe.route = spy
    try:
        yield got
    finally:
        tmoe.route = orig


def _layer_moe(arch, dtype, **changes):
    """The first stacked layer's MoE in both packages, and both cfgs."""
    jc, tc, params, model = lm._models(arch, dtype)
    jc = dataclasses.replace(jc, **changes)
    tc = dataclasses.replace(tc, **changes)
    jp = jax.tree.map(lambda a: a[0], params["stack"]["l0"]["moe"])
    return jc, tc, jp, model.stack[0].moe


# (label, B, S, cfg changes): a prefill of two groups; capacity cut so
# that experts overflow and tokens are dropped; a decode step of two
# tokens (G = 2 < 4, C = 4 > G)
MOE_CASES = [("prefill 2x64", 2, 64, {}),
             ("overflow cf0.5", 2, 64, {"capacity_factor": 0.5}),
             ("decode G2", 2, 1, {})]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label,B,S,changes", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(arch, label, B, S, changes, dtype):
    jc, tc, jp, tp = _layer_moe(arch, dtype, **changes)
    jx, tx = lm._x((B, S, jc.d_model), dtype, seed=20)
    with reference_routing() as ref:
        want, jaux = jmoe.apply_moe(jp, jc, jx)
    with port_routing() as got_r:
        got, aux = tmoe.apply_moe(tp, tc, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    lm._close(got, want, dtype)
    (r,) = got_r
    (jd,), (jcomb,) = ref["dispatch"], ref["combine"]
    assert r["dispatch"].dtype == torch.float32
    assert np.array_equal(r["dispatch"].numpy(), jd)
    np.testing.assert_allclose(r["combine"].numpy(), jcomb, **lm.FP32_TOL)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=AUX_RTOL)
    G, C = tmoe.capacity(tc, B * S)
    kept = int(r["dispatch"].sum())
    if label.startswith("overflow"):
        assert kept < B * S * tc.top_k       # some (token, slot) dropped
    if label.startswith("decode"):
        assert (G, C) == (2, 4) and kept == B * S * tc.top_k


def test_moe_top_k_breaks_ties_to_the_lowest_expert():
    """A zero router gives every expert the same probability: both
    packages take experts 0..k-1 for every token, and the first C tokens
    fill those experts' C slots in token order; the rest are dropped."""
    jc, tc, jp, tp = _layer_moe(ARCH, "float32")
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp.router.w.data.zero_()
    jx, tx = lm._x((1, 8, jc.d_model), "float32", seed=21)
    with reference_routing() as ref:
        jmoe.apply_moe(jp, jc, jx)
    with port_routing() as got:
        tmoe.apply_moe(tp, tc, tx)
    d = got[0]["dispatch"].numpy()
    assert np.array_equal(d, ref["dispatch"][0])
    G, C = tmoe.capacity(tc, 8)
    K = tc.top_k
    assert (G, C) == (8, 5)
    slots = np.zeros((G, tc.n_experts, C), np.float32)
    for g in range(C):
        slots[g, :K, g] = 1.0
    assert np.array_equal(d[0], slots)


def test_moe_tokens_must_fill_whole_groups():
    jc, tc, jp, tp = _layer_moe(ARCH, "float32")
    jx, tx = lm._x((3, 32, jc.d_model), "float32", seed=22)  # 96 % 64
    with pytest.raises(AssertionError, match="tokens 96 not divisible by "
                                             "group 64") as want:
        jmoe.apply_moe(jp, jc, jx)
    with pytest.raises(AssertionError) as got:
        tmoe.apply_moe(tp, tc, tx)
    assert str(got.value) == str(want.value)


def _flips(ref_d, port_r, k):
    """The tokens of one MoE call whose kept (token, expert) pairs differ
    between the packages, flattened: (flipped, near_tie, cascade).
    near_tie: two of the token's top k + 1 experts (by the port's fp32
    router logits) are within ``NEAR_TIE``; cascade: an earlier token of
    its group flipped at a near-tie, which moved the capacity slots of
    the tokens after it."""
    got = port_r["dispatch"].sum(-1).numpy()           # (n, G, E) kept
    flipped = (got != ref_d.sum(-1)).any(-1)           # (n, G)
    logits = port_r["logits"].numpy()
    x = port_r["xt"].to(torch.float32).numpy()
    w = port_r["w"].to(torch.float32).numpy()
    tie = np.zeros_like(flipped)
    for i, g in zip(*np.nonzero(flipped)):
        top = np.argsort(-logits[i, g], kind="stable")[:k + 1]
        for e1, e2 in zip(top[:-1], top[1:]):
            reach = NEAR_TIE * np.abs(x[i, g]) @ np.abs(w[:, e1] - w[:, e2])
            tie[i, g] |= abs(logits[i, g, e1] - logits[i, g, e2]) <= reach
    cascade = np.cumsum(tie, axis=1) - tie > 0
    return flipped.reshape(-1), tie.reshape(-1), cascade.reshape(-1)


def _unreached(ref_ds, port_rs, coords, k, shape):
    """Hold every routing flip of a run to its explanation and return
    (number of flips, mask of the logits rows no flip reached).

    The MoE calls come in the order they ran, call c with its tokens'
    (row, position) ``coords[c]``.  A flip is explained by ``_flips``,
    or by an earlier call's flip in the same row at a position at or
    before it (attention, or a decode step's cache, carried it there).
    A logits row (row, position) is reached by any flip in its row at
    or before its position."""
    events = []
    for jd, r, (rows, pos) in zip(ref_ds, port_rs, coords):
        flipped, tie, cascade = _flips(jd, r, k)
        new = []
        for t in np.nonzero(flipped)[0]:
            carried = any(b == rows[t] and s <= pos[t] for b, s in events)
            assert tie[t] or cascade[t] or carried, (rows[t], pos[t])
            new.append((rows[t], pos[t]))
        events += new
    reached = np.zeros(shape, bool)
    for b, s in events:
        reached[b, s:] = True
    return len(events), ~reached


def _whole(arch, dtype, B=2, S=64):
    jc, tc, params, model = lm._models(arch, dtype)
    toks = np.random.default_rng(23).integers(0, jc.vocab_size, (B, S))
    with reference_routing() as ref:
        want, jaux = jforward(params, jc, {"tokens": jnp.asarray(toks)},
                              remat=False)
    with port_routing() as got_r:
        got, aux = forward(model, tc, {"tokens": toks})
    return tc, lm._np(got), lm._np(want), aux, jaux, ref, got_r


def _argmax_held(got, want):
    """In every row the port's argmax is a maximiser of the reference's
    logits within two bf16 ulps of the reference's largest logit."""
    top = want.max(-1)
    at = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
    ulp = np.exp2(np.floor(np.log2(np.abs(top) + 1e-30)) - 7)
    assert (at >= top - 2 * ulp).all(), np.nonzero(at < top - 2 * ulp)


def _n_moe(cfg):
    return sum(s.mlp == "moe" for s in cfg.prologue) + cfg.repeats * sum(
        s.mlp == "moe" for s in cfg.pattern)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch, dtype):
    tc, got, want, aux, jaux, ref, got_r = _whole(arch, dtype)
    assert len(got_r) == len(ref["dispatch"]) == _n_moe(tc)
    assert float(aux) > 0.0
    if dtype == "float32":
        lm._close(got, want, dtype, argmax=True)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
        for r, jd in zip(got_r, ref["dispatch"]):
            assert np.array_equal(r["dispatch"].numpy(), jd)
        return
    B, S = got.shape[:2]
    t = np.arange(B * S)
    n_flips, keep = _unreached(ref["dispatch"], got_r,
                               [(t // S, t % S)] * len(got_r), tc.top_k,
                               (B, S))
    assert n_flips <= 0.05 * B * S * len(got_r), n_flips
    assert keep.sum() >= B * S // 4, keep.sum()
    lm._close(got[keep], want[keep], dtype)
    _argmax_held(got[keep], want[keep])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_step_matches_reference(arch, dtype):
    """Six decode steps of 4 rows from a cache pre-filled to position 3;
    each step routes its 4 tokens as one group (C = 4: none dropped), so
    a bf16 flip is a near-tie, and it reaches its row's later steps."""
    jc, tc, params, model = lm._models(arch, dtype)
    B, steps = 4, 6
    toks = np.random.default_rng(24).integers(0, jc.vocab_size, (B, steps))
    jc_ = jcache(params, jc, B, 12, prefilled=3)
    tc_ = init_serve_cache(model, tc, B, 12, prefilled=3)
    got, want = [], []
    with reference_routing() as ref, port_routing() as got_r:
        for t in range(steps):
            jlg, jc_ = jstep(params, jc, jc_, jnp.asarray(toks[:, t:t + 1]))
            tlg, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
            got.append(lm._np(tlg)[:, 0])
            want.append(lm._np(jlg)[:, 0])
    assert tc_["pos"] == int(jc_["pos"]) == 9
    got, want = np.stack(got, 1), np.stack(want, 1)        # (B, steps, V)
    assert len(got_r) == len(ref["dispatch"]) == steps * _n_moe(tc)
    if dtype == "float32":
        lm._close(got, want, dtype, argmax=True)
        return
    coords = [(np.arange(B), np.full(B, c // _n_moe(tc)))
              for c in range(len(got_r))]
    n_flips, keep = _unreached(ref["dispatch"], got_r, coords, tc.top_k,
                               (B, steps))
    assert n_flips <= 0.05 * B * len(got_r), n_flips
    assert keep.sum() >= B * steps // 2, keep.sum()
    lm._close(got[keep], want[keep], dtype)
    _argmax_held(got[keep], want[keep])


def _serve(server, prompts, max_new):
    ids = [server.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in server.run()}
    return [done[i]["generated"] for i in ids]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_generate_and_batched_server_match_reference(arch):
    """fp32: ``generate`` and a ``BatchedServer`` of 5 requests through
    2 slots (free slots feed token 0, which the reference routes with
    the rest of the step) give the reference's tokens; prompts admitted
    into every slot at once give ``generate``'s tokens, to the bit."""
    jc, tc, params, model = lm._models(arch, "float32")
    prompts = JTokenStream(jc.vocab_size, 0).batch(0, 4, 7)[:, :7]
    assert np.array_equal(prompts, TokenStream(tc.vocab_size, 0)
                          .batch(0, 4, 7)[:, :7])
    with jax.threefry_partitionable(False):
        want = jserve.generate(jc, params, prompts, max_new=5)
        jsrv = jserve.BatchedServer(jc, params, slots=2, max_len=64)
        want_srv = _serve(jsrv, list(prompts) + [prompts[0][:4]], 4)
    got = tserve.generate(tc, model, prompts, max_new=5)
    assert np.array_equal(got, want)
    tsrv = tserve.BatchedServer(tc, model, slots=2, max_len=64)
    assert _serve(tsrv, list(prompts) + [prompts[0][:4]], 4) == want_srv
    together = tserve.BatchedServer(tc, model, slots=4, max_len=40)
    assert np.array_equal(np.asarray(_serve(together, list(prompts), 5)),
                          got[:, 7:])


def _batch(vocab):
    b = make_lm_batch(TokenStream(vocab, seed=1), 0, 2, 32, device="cpu")
    b["labels"][0, 3] = -1
    return b


@pytest.fixture(scope="module")
def reference_loss_and_grads():
    jc, tc = lm._cfgs(ARCH, "float32")
    with jax.threefry_partitionable(False):
        params = jinit(jax.random.PRNGKey(0), jc)
        jb = {k: jnp.asarray(v.numpy().astype(np.int32))
              for k, v in _batch(tc.vocab_size).items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, jc, jb, remat=True), has_aux=True))(params)
    return params, float(loss), float(met["aux"]), jax.tree.map(np.asarray,
                                                                 grads)


def _port_loss_and_grads(params, remat):
    _, tc = lm._cfgs(ARCH, "float32")
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tc,
                                     device="cpu", train=True)
    loss, met = loss_fn(model, tc, _batch(tc.vocab_size), remat=remat)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return model, loss.detach(), met, dict(zip(named, grads))


def test_grok_loss_and_gradients_match_reference(reference_loss_and_grads):
    params, want_loss, want_aux, want_grads = reference_loss_and_grads
    model, loss, met, grads = _port_loss_and_grads(params, remat=True)
    np.testing.assert_allclose(float(loss), want_loss, **lm.FP32_TOL)
    aux = float(met["aux"].detach())
    np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL)
    assert aux > 0.0
    names = {n for n, _ in model.named_parameters()}
    assert set(grads) == names and any(".moe.router.w" in n for n in names)
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg)
        got = g.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, **lm.FP32_TOL, err_msg=name)


def test_grok_remat_gives_the_same_gradient_bits(reference_loss_and_grads):
    params = reference_loss_and_grads[0]
    _, la, _, ga = _port_loss_and_grads(params, remat=True)
    _, lb, _, gb = _port_loss_and_grads(params, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


@pytest.mark.parametrize("arch,train", [("deepseek_v2_lite_16b", False),
                                        ("grok_1_314b", True)],
                         ids=["deepseek-serve", "grok-train"])
def test_router_is_held_in_fp32(arch, train):
    """The reference reads its router's fp32 master even in bf16; the
    port holds it in fp32 in a serving model too (the experts in bf16),
    and ``init_model`` draws the reference's leaves, shapes and
    distributions (normal * 1/sqrt(fan_in), norm scales 1)."""
    jc, tc = lm._cfgs(arch, "bfloat16")
    model = init_model(tc, seed=1, device="cpu", train=train)
    with jax.threefry_partitionable(False):
        ref = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
    leaves = {n: reference_leaf(ref, n, tc)
              for n, _ in model.named_parameters()}
    assert sum(x.size for x in leaves.values()) == sum(
        x.size for x in jax.tree.leaves(ref))
    for name, p in model.named_parameters():
        fp32 = train or name.endswith((".scale", ".router.w"))
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name
        assert tuple(p.shape) == leaves[name].shape, name
        if name.endswith(".scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif "embed" not in name:
            # fan_in: the input width, the middle axis of (E, in, out)
            fan_in = p.shape[-2]
            std = float(p.detach().float().std()) * np.sqrt(fan_in)
            assert abs(std - 1.0) < 0.1, (name, std)
    shared = ("shared_gate", "shared_in", "shared_down") \
        if tc.n_shared_experts else ()
    assert {n for n, _ in model.named_parameters()
            if n.startswith("stack.0.moe.")} == {
        f"stack.0.moe.{k}.w" for k in (
            "router", "experts_gate", "experts_in", "experts_down") + shared}


def _decode_vs_forward(fwd, init_cache, step, cfg, params, toks):
    """(decode logits, forward logits) of replaying ``toks`` token by
    token through the decode path, as numpy fp32."""
    par, _ = fwd(params, cfg, toks)
    caches = init_cache(params, cfg, toks.shape[0], toks.shape[1])
    dec = []
    for t in range(toks.shape[1]):
        lg, caches = step(params, cfg, caches, toks[:, t:t + 1])
        dec.append(lm._np(lg)[:, 0])
    return np.stack(dec, 1), lm._np(par)


def test_capacity_drops_part_decode_from_forward_in_both_packages():
    """fp32, deepseek smoke: a forward routes groups of 64 tokens (C =
    40), a decode step its 8 tokens (C = 5), so the two drop different
    tokens and decode's logits leave the forward's, in the reference as
    in the port, at the same rows; with capacity_factor E/k no group
    drops a token and decode gives the forward's logits."""
    jc, tc, params, model = lm._models("deepseek_v2_lite_16b", "float32")
    toks = np.random.default_rng(25).integers(0, jc.vocab_size, (8, 16))

    def jfwd(p, c, t):
        return jforward(p, c, {"tokens": jnp.asarray(t)}, remat=False)

    def jdec(p, c, caches, t):
        return jstep(p, c, caches, jnp.asarray(t))

    def tfwd(p, c, t):
        return forward(p, c, {"tokens": t})

    jd, jf = _decode_vs_forward(jfwd, jcache, jdec, jc, params, toks)
    td, tf = _decode_vs_forward(tfwd, init_serve_cache, serve_step, tc,
                                model, toks)
    lm._close(td, jd, "float32")
    lm._close(tf, jf, "float32")
    apart = np.abs(td - tf).max(-1) > 1e-3
    assert apart.any() and np.array_equal(apart,
                                          np.abs(jd - jf).max(-1) > 1e-3)
    nodrop = {"capacity_factor": tc.n_experts / tc.top_k}
    td, tf = _decode_vs_forward(tfwd, init_serve_cache, serve_step,
                                dataclasses.replace(tc, **nodrop), model,
                                toks)
    lm._close(td, tf, "float32")
