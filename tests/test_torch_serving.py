"""The port's serving layer: resident cache + RecommendServer.

The port's counterparts of ``tests/test_serving.py``, on a store the
port trains on the CPU (Normal priors: the Macau prior, and with it
cold start, is not ported yet):

* after the first request warms the resident cache, every further
  ``predict``/``predict_all``/``recommend`` performs zero checkpoint
  loads;
* batching changes no answer: ``RecommendServer`` results are bitwise
  equal to sequential ``PredictSession.recommend`` calls;
* request ids are monotonic, and a duplicate explicit id raises.

Messages the two packages share are compared with the reference's on
the same store.  The over-budget fallback sums in another order than
the cached path: means at rtol 1e-6 / atol 1e-7 and stds at rtol 1e-3 /
atol 1e-6, the reference's own tolerances for that comparison.
"""
import jax
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.obs import metrics as jmetrics
from repro_torch.core import predict as tpredict
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import RecommendServer, SlotServer
from repro_torch.obs import Histogram, Recorder, percentile_summary
from torch_threads import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A small store saved by the port: (save_dir, obs, test)."""
    rng = np.random.default_rng(0)
    n_c, n_t, rank = 36, 20, 3
    act = rng.normal(size=(n_c, rank)) @ rng.normal(size=(rank, n_t))
    obs = rng.random((n_c, n_t)) < 0.6
    i, j = np.nonzero(obs)
    mat = tc.from_coo(i, j, act[i, j].astype(np.float32), (n_c, n_t),
                      device="cpu")
    d = tmp_path_factory.mktemp("port_serving_store")
    b = tc.ModelBuilder(num_latent=4, device="cpu")
    b.add_entity("compound", n_c).add_entity("target", n_t)
    b.add_block("compound", "target", mat, noise=tc.AdaptiveGaussian())
    b.session(burnin=5, nsamples=6, seed=0, save_freq=1,
              save_dir=str(d)).run()
    return str(d), obs


def _session(d, **kw):
    return tc.PredictSession(d, device="cpu", **kw)


def _reference(d, **kw):
    with jax.threefry_partitionable(False):
        return jc.PredictSession(d, **kw)


def test_second_request_zero_checkpoint_loads(store):
    d, _ = store
    p = _session(d)
    assert p.load_count == 0
    p.recommend(user=[0, 1], k=3)
    assert p.load_count == p.num_samples    # the one-time warm
    warm = p.load_count
    p.recommend(user=[2, 3], k=5)
    p.predict([0, 1], [2, 3])
    p.predict_all()
    p.predict_all(("target", "compound"))
    assert p.load_count == warm
    assert p.cache_resident
    stats = p.cache_stats()
    assert stats["misses"] == 1 and stats["hits"] >= 4
    assert stats["resident_bytes"] == p.warm_cache().nbytes() > 0


def test_cached_predict_bitwise_equals_lazy(store):
    d, _ = store
    cached = _session(d)
    lazy = _session(d, cache_bytes=0)
    assert lazy.warm_cache() is None
    i, j = [0, 5, 9], [1, 2, 3]
    np.testing.assert_array_equal(cached.predict(i, j), lazy.predict(i, j))
    np.testing.assert_array_equal(cached.predict_all(), lazy.predict_all())
    np.testing.assert_array_equal(
        cached.predict(j, i, block=("target", "compound")),
        lazy.predict(i, j))
    assert not lazy.cache_resident and lazy.load_count > 0
    assert lazy.cache_stats()["over_budget"] >= 1


def test_over_budget_recommend_falls_back(store):
    d, _ = store
    cached = _session(d).recommend(user=[0, 1, 2], k=5)
    lazy = _session(d, cache_bytes=0).recommend(user=[0, 1, 2], k=5)
    np.testing.assert_array_equal(cached.ids, lazy.ids)
    np.testing.assert_allclose(cached.mean, lazy.mean, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(cached.std, lazy.std, rtol=1e-3, atol=1e-6)
    # and the reference's own fallback on the same store agrees
    ref = _reference(d, cache_bytes=0).recommend(user=[0, 1, 2], k=5)
    np.testing.assert_array_equal(lazy.ids, ref.ids)


def test_store_nbytes_gates_residency(store):
    d, _ = store
    p = _session(d)
    assert 0 < p.store_nbytes() < p.cache_bytes
    assert _session(d, cache_bytes=0).store_nbytes() == p.store_nbytes()
    assert p.store_nbytes() == _reference(d).store_nbytes()
    assert _session(d, cache_bytes=p.store_nbytes()).warm_cache() \
        is not None
    assert _session(d, cache_bytes=p.store_nbytes() - 1).warm_cache() \
        is None


def test_spec_cached_across_instances(store):
    d, _ = store
    before = tpredict.spec_cache_stats()["hits"]
    assert _session(d).spec is _session(d).spec
    assert tpredict.spec_cache_stats()["hits"] >= before + 2


def test_load_sample_unknown_step_still_raises(store):
    d, _ = store
    p = _session(d)
    with pytest.raises(ValueError, match="no sample at step"):
        p.load_sample(10**9)
    step, st = p.restore_latest()
    assert step == max(p.steps) and st.step == step


def test_recommend_batched_equals_sequential_bitwise(store):
    d, _ = store
    p = _session(d)
    users = [0, 3, 7, 11]
    batched = p.recommend(user=users, k=5)
    for b, u in enumerate(users):
        single = p.recommend(user=u, k=5)
        np.testing.assert_array_equal(batched.ids[b], single.ids[0])
        np.testing.assert_array_equal(batched.mean[b], single.mean[0])
        np.testing.assert_array_equal(batched.std[b], single.std[0])


def test_recommend_exclusion_and_clamping(store):
    d, obs = store
    p = _session(d)
    seen = np.nonzero(obs[0])[0]
    r = p.recommend(user=[0], k=8, exclude=[seen])
    assert not set(r.ids[0][r.ids[0] >= 0]) & set(seen.tolist())
    n_items = obs.shape[1]
    big = p.recommend(user=[0], k=n_items + 50)
    assert big.ids.shape == (1, n_items)          # K > n_items clamps
    almost = list(range(n_items - 2))
    t = p.recommend(user=[0], k=5, exclude=[almost])
    assert (t.ids[0][2:] == -1).all()
    assert np.isnan(t.mean[0][2:]).all() and (t.ids[0][:2] >= 0).all()
    # the flipped block ranks compounds for a target
    flip = p.recommend(user=[2], k=4, block=("target", "compound"))
    dense = p.predict_all(("target", "compound"))
    assert flip.ids[0, 0] == int(np.argmax(dense[2]))


@pytest.mark.parametrize("call", [
    lambda p: p.recommend(user=100),
    lambda p: p.recommend(),
    lambda p: p.recommend(user=[0, 1], k=3, exclude=[[1]]),
    lambda p: p.recommend(user=[0], exclude=[[99]]),
    lambda p: p.recommend(user=[0], block=("target", "target")),
    lambda p: p.recommend(user=[0], block=3),
    lambda p: p.recommend(features=np.zeros((1, 3), np.float32)),
    lambda p: p.predict_new("compound", np.zeros((1, 3), np.float32)),
    lambda p: p.load_sample(4, chain=2),
])
def test_validation_errors_carry_reference_messages(store, call):
    d, _ = store
    with pytest.raises(ValueError) as je:
        with jax.threefry_partitionable(False):
            call(_reference(d))
    with pytest.raises(ValueError) as te:
        call(_session(d))
    assert str(te.value) == str(je.value)


def test_recommend_server_bitwise_vs_sequential(store):
    d, obs = store
    sess = _session(d)
    srv = RecommendServer(sess, slots=3, k=5)
    warm_loads = sess.load_count
    tops.reset_launch_counts()
    reqs = {}
    for u in range(7):
        excl = np.nonzero(obs[u])[0] if u % 2 else None
        reqs[srv.submit(user=u, exclude=excl,
                        k=3 if u == 4 else None)] = (u, excl)
    done = {r["id"]: r for r in srv.run()}
    assert len(done) == len(reqs)
    assert sess.load_count == warm_loads     # zero loads while serving
    assert tops.launch_counts()["topk_score"] == 0   # the CPU path
    for rid, (u, excl) in reqs.items():
        seq = sess.recommend(user=u, k=3 if u == 4 else 5,
                             exclude=None if excl is None else [excl])
        np.testing.assert_array_equal(done[rid]["ids"], seq.ids[0])
        np.testing.assert_array_equal(done[rid]["mean"], seq.mean[0])
        np.testing.assert_array_equal(done[rid]["std"], seq.std[0])
        assert done[rid]["t_done"] >= done[rid]["t_admit"] \
            >= done[rid]["t_submit"]
    snap = srv.metrics_snapshot()
    assert snap["counters"]["serve.completed"] == 7
    for h in ("serve.queue_wait_s", "serve.execute_s",
              "serve.batch_occupancy"):
        assert snap["histograms"][h]["total"] > 0
    occ = Histogram.from_dict(snap["histograms"]["serve.batch_occupancy"])
    assert occ.total == 3 and occ.sum == 7.0       # steps of 3, 3, 1


def test_recommend_server_refuses_over_budget_store(store):
    d, _ = store
    with pytest.raises(ValueError, match="resident"):
        RecommendServer(_session(d, cache_bytes=0))


def test_recommend_server_request_validation(store):
    d, _ = store
    srv = RecommendServer(_session(d))
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit(user=0, features=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="exactly one"):
        srv.submit()
    with pytest.raises(ValueError, match="one .D,. row"):
        srv.submit(features=np.zeros((2, 3), np.float32))


class _EchoServer(SlotServer):
    """Trivial service: each step completes every active request."""

    def submit(self, payload, req_id=None):
        return self._enqueue({"payload": payload}, req_id)

    def step(self):
        for s, req in enumerate(self.active):
            if req is not None:
                req["echo"] = req["payload"]
                self._finish(s)


def test_slot_ids_monotonic_across_queue_drains():
    srv = _EchoServer(slots=2)
    a = srv.submit("x")
    srv.run()
    b = srv.submit("y")                 # queue drained in between
    srv.run()
    assert a != b
    assert len({r["id"] for r in srv.done}) == 2


def test_slot_duplicate_explicit_id_raises_naming_clash():
    srv = _EchoServer(slots=2)
    srv.submit("x", req_id="dup")
    with pytest.raises(ValueError, match="'dup'"):
        srv.submit("y", req_id="dup")
    srv.run()
    srv.submit("z", req_id="dup")       # reusable once completed
    assert len(srv.run()) == 2


def test_slot_server_more_requests_than_slots():
    srv = _EchoServer(slots=2)
    ids = [srv.submit(i) for i in range(7)]
    done = srv.run()
    assert [r["id"] for r in done] == ids      # FIFO admission
    assert [r["echo"] for r in done] == list(range(7))


def test_histograms_match_the_reference():
    """The copied obs histograms give the reference's percentiles."""
    rng = np.random.default_rng(1)
    xs = rng.lognormal(-6, 1.5, size=500)
    rec = Recorder(enabled=True)
    jh = jmetrics.Histogram(jmetrics.latency_buckets())
    for x in xs:
        rec.observe("lat", x)
        jh.observe(x)
    assert rec.histogram("lat").to_dict() == jh.to_dict()
    assert percentile_summary(rec.histogram("lat")) == \
        jmetrics.percentile_summary(jh)
    assert Recorder(enabled=False).now() == 0.0
