"""Jamba's hybrid period served with its sliding window against the
JAX package's, on the CPU: decode steps past the ring buffer's wrap,
decode against the port's own forward, ``generate`` and
``BatchedServer``.

The models, the window (8 here, a ring buffer of 8 rows) and the
tolerances are ``test_torch_jamba.py``'s: fp32 logits at rtol 1e-4
with atol at ``SCALED_ATOL`` of the largest |value|, argmax agreement
above 0.999; tokens equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_lm as lm
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch import serve as jserve
from repro.models import init_serve_cache as jcache, serve_step as jstep
from repro_torch.launch import serve as tserve
from repro_torch.models import forward, init_serve_cache, serve_step
from test_torch_jamba import ATTN, WINDOW, _close, _models
from torch_threads import _one_thread  # noqa: F401 (autouse)


def test_windowed_serve_steps_past_the_wrap_match_reference():
    """fp32, window 8: 40 decode steps of 2 rows from empty caches (the
    ring buffer of 8 rows wraps five times): each step's logits, then
    every layer's cache (ring buffers and Mamba2 states)."""
    jc, tc, params, model = _models("float32")
    toks = np.random.default_rng(64).integers(0, jc.vocab_size, (2, 40))
    jc_ = jcache(params, jc, 2, 48)
    tc_ = init_serve_cache(model, tc, 2, 48)
    assert tc_["stack"][ATTN]["mixer"]["k"].shape[1] == WINDOW
    step = jax.jit(lambda p, c, x: jstep(p, jc, c, x))
    got, want = [], []
    for t in range(40):
        jlg, jc_ = step(params, jc_, jnp.asarray(toks[:, t:t + 1]))
        tlg, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
        got.append(lm._np(tlg)[:, 0])
        want.append(lm._np(jlg)[:, 0])
    _close(np.stack(got, 1), np.stack(want, 1), argmax=True)
    assert tc_["pos"] == int(jc_["pos"]) == 40
    for i, layer in enumerate(tc_["stack"]):
        want_c = jc_["stack"][f"l{i}"]["mixer"]
        assert set(layer["mixer"]) == set(want_c)
        for name, x in layer["mixer"].items():
            _close(x, want_c[name][0])


def test_windowed_decode_matches_forward_in_port():
    """fp32 at capacity_factor E/k (no group drops a token, so a decode
    step routes each token as the forward does): 64 positions decoded
    through the ring buffer against one forward at the same window."""
    _, tc, _, model = _models("float32", capacity_factor=4 / 2)
    assert tc.n_experts / tc.top_k == tc.capacity_factor
    toks = np.random.default_rng(65).integers(0, tc.vocab_size, (2, 64))
    par, _ = forward(model, tc, {"tokens": toks})
    caches = init_serve_cache(model, tc, 2, 64)
    dec = []
    for t in range(64):
        lg, caches = serve_step(model, tc, caches, toks[:, t:t + 1])
        dec.append(lg[:, 0])
    _close(torch.stack(dec, 1), par, argmax=True)


def _serve(server, prompts, max_new):
    ids = [server.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in server.run()}
    return [done[i]["generated"] for i in ids]


def test_windowed_generate_and_batched_server_match_reference():
    """fp32, window 8: ``generate`` (7 prompt tokens + 6 new, past the
    wrap) and a ``BatchedServer`` of 5 requests through 2 slots give the
    reference's tokens."""
    jc, tc, params, model = _models("float32")
    prompts = JTokenStream(jc.vocab_size, 0).batch(0, 4, 7)[:, :7]
    with jax.threefry_partitionable(False):
        want = jserve.generate(jc, params, prompts, max_new=6)
        jsrv = jserve.BatchedServer(jc, params, slots=2, max_len=64)
        want_srv = _serve(jsrv, list(prompts) + [prompts[0][:4]], 4)
    assert np.array_equal(tserve.generate(tc, model, prompts, max_new=6),
                          want)
    tsrv = tserve.BatchedServer(tc, model, slots=2, max_len=64)
    assert _serve(tsrv, list(prompts) + [prompts[0][:4]], 4) == want_srv
