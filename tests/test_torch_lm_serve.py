"""The port's LM serving (``generate``, ``BatchedServer``) against the
JAX package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights (carried over by ``convert.lm_params_from_reference``) in fp32
(``dtype="float32"``), on prompts from ``TokenStream``, whose copy in
the port gives the reference's tokens.  Tokens are compared exactly:
in fp32 the two packages' logits agree to about 1e-6 relative
(``test_torch_lm.py`` holds them at rtol 1e-4), far inside the gaps
between a row's top logits, so greedy and Gumbel-max choices agree.
The reference's ``BatchedServer`` keeps one position counter for all
slots and clamps cache writes past ``max_len``; the port reproduces
both, and the tests pin them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch import serve as jserve
from repro.models import init_model as jinit
from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import TokenStream
from repro_torch.launch import serve as tserve
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "qwen3_4b"


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jcfg.get_smoke(ARCH), dtype="float32")
    tc = dataclasses.replace(tcfg.get_smoke(ARCH), dtype="float32")
    with jax.threefry_partitionable(False):
        params = jinit(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, params)
    return jc, tc, params, lm_params_from_reference(tree, tc, device="cpu")


def _prompts(vocab, B, S, seed=0):
    return TokenStream(vocab, seed).batch(0, B, S)[:, :S]


def test_token_stream_matches_reference():
    for seed in (0, 3):
        got = TokenStream(151936, seed).batch(5, 4, 33)
        want = JTokenStream(151936, seed).batch(5, 4, 33)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_generate_tokens_match_reference(models, temperature):
    jc, tc, params, model = models
    prompts = _prompts(jc.vocab_size, 3, 7)
    with jax.threefry_partitionable(False):
        want = jserve.generate(jc, params, prompts, max_new=6,
                               temperature=temperature, seed=4)
    got = tserve.generate(tc, model, prompts, max_new=6,
                          temperature=temperature, seed=4)
    assert got.dtype == np.int32 and got.shape == (3, 13)
    assert np.array_equal(got[:, :7], prompts)
    assert np.array_equal(got, want)


def _serve(server, prompts, max_new):
    ids = [server.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in server.run()}
    return ids, [done[i]["generated"] for i in ids]


def test_batched_server_matches_reference_shared_position(models):
    """5 requests through 2 slots: the later requests start at the
    server's shared position and see their slot's earlier cache rows,
    in both packages alike."""
    jc, tc, params, model = models
    prompts = list(_prompts(jc.vocab_size, 5, 6, seed=1))
    with jax.threefry_partitionable(False):
        jsrv = jserve.BatchedServer(jc, params, slots=2, max_len=64)
        _, want = _serve(jsrv, prompts, 4)
    tsrv = tserve.BatchedServer(tc, model, slots=2, max_len=64)
    ids, got = _serve(tsrv, prompts, 4)
    assert got == want
    assert ids == [f"r{i}" for i in range(5)]
    assert tsrv.caches["pos"] == int(jsrv.caches["pos"])
    # the fault pinned: request 4 served alone answers otherwise
    alone = tserve.BatchedServer(tc, model, slots=2, max_len=64)
    _, solo = _serve(alone, prompts[4:], 4)
    assert solo[0] != got[4]
    snap = tsrv.metrics_snapshot()
    assert snap["counters"]["serve.completed"] == 5


def test_batched_server_clamps_cache_writes_past_max_len(models):
    """Past max_len each step overwrites the cache's last row and the
    server carries on, as the reference's clamped update does."""
    jc, tc, params, model = models
    prompts = list(_prompts(jc.vocab_size, 3, 5, seed=2))
    with jax.threefry_partitionable(False):
        jsrv = jserve.BatchedServer(jc, params, slots=1, max_len=8)
        _, want = _serve(jsrv, prompts, 3)
    tsrv = tserve.BatchedServer(tc, model, slots=1, max_len=8)
    _, got = _serve(tsrv, prompts, 3)
    assert got == want
    assert tsrv.caches["pos"] == int(jsrv.caches["pos"]) == 21
    for i, layer in enumerate(tsrv.caches["stack"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer["mixer"][name].numpy(),
                np.asarray(jsrv.caches["stack"]["l0"]["mixer"][name][i]),
                rtol=1e-4, atol=1e-5)


def test_batched_server_ids_are_monotonic_and_clashes_raise(models):
    _, tc, _, model = models
    srv = tserve.BatchedServer(tc, model, slots=2, max_len=32)
    prompt = np.arange(3)
    first = [srv.submit(prompt, max_new=1) for _ in range(3)]
    srv.run()
    later = [srv.submit(prompt, max_new=1) for _ in range(2)]
    assert first + later == ["r0", "r1", "r2", "r3", "r4"]
    srv.submit(prompt, max_new=1, req_id="mine")
    with pytest.raises(ValueError, match="clashes"):
        srv.submit(prompt, max_new=1, req_id="mine")


def test_batched_server_admitted_together_equals_generate(models):
    """Prompts admitted into every slot at once decode the tokens of
    ``generate`` on the same prompts, to the bit, whatever the two
    cache lengths."""
    _, tc, _, model = models
    prompts = _prompts(tc.vocab_size, 4, 9, seed=3)
    gen = tserve.generate(tc, model, prompts, max_new=5)
    srv = tserve.BatchedServer(tc, model, slots=4, max_len=40)
    _, got = _serve(srv, list(prompts), 5)
    assert np.array_equal(np.asarray(got), gen[:, 9:])


def test_lm_entry_points_raise_without_cuda(models, monkeypatch):
    _, tc, _, model = models
    from repro_torch.models import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_reference({}, tc)
