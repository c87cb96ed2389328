"""Serving: the slot/queue runtime, LM decoding and the recommendation
service.

The counterpart of ``make_serve_step``, ``generate``, ``SlotServer``,
``BatchedServer`` and ``RecommendServer`` in ``repro/launch/serve.py``.
Requests queue, free slots admit them, and one service step advances
every active slot at once:

* :class:`BatchedServer` decodes LM tokens over fixed KV-cache slots
  with ``models.serve_step``;
* :class:`RecommendServer` scores all admitted requests in one
  ``kernels.ops.topk_score`` call (the hand-written CUDA kernel on the
  card) against the resident posterior cache of a
  :class:`~repro_torch.core.predict.PredictSession`.  Batching changes
  no answer: each query runs one identical float program whatever the
  batch, so results are bitwise equal to sequential
  ``PredictSession.recommend`` calls.

The store is loaded once, when the server is built (``warm_cache``);
request paths never touch the checkpoint loader.  The reference's
``make_sharded_*`` functions describe an XLA program on a TPU mesh and
are not ported (ROADMAP A11).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as jr
from ..models import forward, init_serve_cache, serve_step
from ..models.config import ModelConfig
from ..obs import Recorder, clock, integer_buckets


def _decoder_only(cfg: ModelConfig, what: str) -> None:
    """Raise ValueError for an encoder-decoder config: ``what`` builds
    its caches without an encoder output, and a cross block has nothing
    to attend to there.  The reference's ``generate`` fails on the
    missing ``batch["enc_frames"]`` and its ``BatchedServer`` attends a
    cross block's query to itself; the port names the route instead."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: {what} serves decoder-only models; an "
            "encoder-decoder model decodes through models.encode -> "
            "init_serve_cache(enc_out=) -> serve_step")


def make_serve_step(cfg: ModelConfig):
    def step(params, caches, tokens):
        return serve_step(params, cfg, caches, tokens)
    return step


def generate(cfg: ModelConfig, params, prompts: np.ndarray,
             max_new: int = 32, temperature: float = 0.0,
             seed: int = 0) -> np.ndarray:
    """Greedy/temperature decode for a batch of same-length prompts ->
    (B, S0 + max_new) int32 tokens, the prompts first.

    As the reference does: the prefill runs ``forward`` (flash
    attention) and its logits are discarded, then the prompt is replayed
    through the decode path to fill a cache of ``S0 + max_new``
    positions.  Greedy is argmax, first index on ties; ``temperature >
    0`` samples ``jax.random.categorical`` from the port's threefry
    stream (``random.categorical``, keys split from ``PRNGKey(seed)``
    as the reference splits them) on fp32 logits / temperature.  A
    model with frontend tokens is served text-only, as the reference
    does; an encoder-decoder model raises ValueError.
    """
    _decoder_only(cfg, "generate")
    prompts = np.asarray(prompts)
    B, S0 = prompts.shape
    max_len = S0 + max_new
    dev = params.device
    forward(params, cfg, {"tokens": prompts})
    caches = init_serve_cache(params, cfg, B, max_len, prefilled=0)
    step = make_serve_step(cfg)
    key = jr.PRNGKey(seed, dev)
    out = [prompts.astype(np.int32)]
    lg = None
    for i in range(S0):
        lg, caches = step(params, caches, prompts[:, i:i + 1])
    for _ in range(max_new):
        if temperature > 0:
            ks = jr.split(key)
            key, k2 = ks[0], ks[1]
            nxt = jr.categorical(k2, lg[:, -1].to(torch.float32)
                                 / temperature)[:, None]
        else:
            nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
        out.append(nxt.cpu().numpy().astype(np.int32))
        lg, caches = step(params, caches, nxt)
    return np.concatenate(out, axis=1)


class SlotServer:
    """Shared slot/queue runtime: admission + request-id management.

    Subclasses implement one service ``step()`` that advances every
    active slot.  Request ids default to a monotonic counter and are
    never reused; an explicit id that clashes with a queued or active
    request raises, naming it.  Every request carries
    ``t_submit``/``t_admit``/``t_done`` monotonic timestamps, and the
    server's Recorder keeps the ``serve.queue_wait_s`` and
    ``serve.execute_s`` histograms and a per-step
    ``serve.batch_occupancy`` histogram, all in
    :meth:`metrics_snapshot`.  The recorder is enabled by default;
    pass a disabled one via ``recorder=`` to opt out.
    """

    def __init__(self, slots: int, recorder: Optional[Recorder] = None):
        self.slots = slots
        self.obs = Recorder(enabled=True) if recorder is None else recorder
        self.obs.set_kind("serve")
        self.queue: List[Dict[str, Any]] = []
        self.active: List[Optional[Dict[str, Any]]] = [None] * slots
        self.done: List[Dict[str, Any]] = []
        self._next_id = 0                 # never reused, ever
        self._live_ids: set = set()       # queued + active

    def _enqueue(self, req: Dict[str, Any],
                 req_id: Optional[str]) -> str:
        if req_id is None:
            req_id = f"r{self._next_id}"
            self._next_id += 1
        elif req_id in self._live_ids:
            raise ValueError(
                f"request id {req_id!r} clashes with a live "
                "(queued or active) request of the same id; pass a "
                "unique id or omit req_id to get a server-assigned "
                "one")
        req["id"] = req_id
        req["t_submit"] = clock.monotonic()
        self._live_ids.add(req_id)
        self.queue.append(req)
        self.obs.add("serve.submitted")
        return req_id

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                req["t_admit"] = clock.monotonic()
                self.obs.observe("serve.queue_wait_s",
                                 req["t_admit"] - req["t_submit"])
                self.active[s] = req

    def _observe_batch(self, occupancy: int) -> None:
        """Batch-occupancy histogram, one observation per service step,
        with an exact bucket per occupancy level 0..slots."""
        self.obs.observe("serve.batch_occupancy", occupancy,
                         bounds=integer_buckets(self.slots))

    def _finish(self, slot: int):
        req = self.active[slot]
        req["t_done"] = clock.monotonic()
        self.obs.observe("serve.execute_s",
                         req["t_done"] - req["t_admit"])
        self.obs.add("serve.completed")
        self._live_ids.discard(req["id"])
        self.done.append(req)
        self.active[slot] = None

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON metrics snapshot of the server's Recorder: submitted/
        completed counters + queue-wait / execute / batch-occupancy
        histograms."""
        return self.obs.metrics()

    def step(self):                       # pragma: no cover
        raise NotImplementedError

    def run(self, max_steps: int = 10_000) -> List[Dict[str, Any]]:
        """Service steps until all requests finish; returns results."""
        for _ in range(max_steps):
            self._admit()
            if not any(self.active):
                break
            self.step()
        return self.done


class BatchedServer(SlotServer):
    """Minimal continuous-batching LM server over fixed decode slots.

    Requests (prompt arrays) queue up; each admitted request feeds its
    prompt one token a step through the decode path, then decodes
    greedily until ``max_new`` tokens.  Every step runs the whole slot
    batch (free slots feed token 0) through ``serve_step``.

    As in the reference, one position counter serves every slot and
    nothing is reset on admission: a request admitted into a slot that
    served before starts at the server's current position and attends
    to the cache rows its slot's earlier requests left there (a Mamba2
    layer: starts from the SSM state and conv window they left), and
    past ``max_len`` each step overwrites the cache's last row (a
    windowed layer's ring buffer wraps instead).  These are the
    reference's behaviour, reproduced on purpose (ROADMAP, queue C).
    An encoder-decoder model raises ValueError (ROADMAP, queue C).
    """

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 256,
                 recorder: Optional[Recorder] = None):
        _decoder_only(cfg, "BatchedServer")
        super().__init__(slots, recorder=recorder)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.caches = init_serve_cache(params, cfg, slots, max_len,
                                       prefilled=0)
        self._step = make_serve_step(cfg)

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               req_id: Optional[str] = None) -> str:
        return self._enqueue(
            {"prompt": list(prompt), "remaining": max_new,
             "generated": [], "fed": 0}, req_id)

    def step(self):
        """One decode step advancing every active slot."""
        self._observe_batch(sum(r is not None for r in self.active))
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if req["fed"] < len(req["prompt"]):
                toks[s, 0] = req["prompt"][req["fed"]]
            elif req["generated"]:
                toks[s, 0] = req["generated"][-1]
        lg, self.caches = self._step(self.params, self.caches, toks)
        nxt = torch.argmax(lg[:, -1], dim=-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req["fed"] += 1
            if req["fed"] >= len(req["prompt"]):
                req["generated"].append(int(nxt[s]))
                req["remaining"] -= 1
                if req["remaining"] <= 0:
                    self._finish(s)


class RecommendServer(SlotServer):
    """Batched posterior top-K recommendation over a saved store.

    Requests (a warm user row id plus optional per-request item
    exclusions) queue up, and each service step scores all admitted
    requests in one ``ops.topk_score`` call against the resident
    posterior cache: top-K item ids with the posterior mean and std of
    each score.  Results are bitwise equal to sequential
    ``PredictSession.recommend`` calls.  A store above the session's
    ``cache_bytes`` budget is refused here: streaming it per request is
    what the resident cache exists to avoid.  Cold-start requests
    (``features=``) map the features through each retained sample of
    the Macau link (``PredictSession.cold_rows``) and are scored in the
    same batch.
    """

    def __init__(self, session, slots: int = 8, k: int = 10,
                 block=0, recorder: Optional[Recorder] = None):
        super().__init__(slots, recorder=recorder)
        self.session = session
        self.k = int(k)
        self.block = block
        if session.warm_cache() is None:
            raise ValueError(
                f"store needs {session.store_nbytes()} bytes resident "
                f"but the session budget is {session.cache_bytes}; "
                "RecommendServer requires the resident cache (raise "
                "cache_bytes / REPRO_PREDICT_CACHE_BYTES, or serve "
                "offline via PredictSession.recommend)")

    def submit(self, user: Optional[int] = None, *,
               features: Optional[np.ndarray] = None,
               k: Optional[int] = None,
               exclude: Optional[Sequence[int]] = None,
               req_id: Optional[str] = None) -> str:
        """Queue one recommendation request; returns its id.

        ``user``: a row id seen in training; ``features``: a (D,)
        side-information vector for an unseen user -- exactly one of
        the two.  ``exclude``: item ids to leave out of this request's
        ranking (e.g. the user's observed items).
        """
        if (user is None) == (features is None):
            raise ValueError(
                "pass exactly one of user= (warm row id) or "
                "features= (cold-start side info)")
        if features is not None:
            features = np.asarray(features, np.float32)
            if features.ndim != 1:
                raise ValueError(
                    f"features must be one (D,) row, got shape "
                    f"{features.shape}; submit one request per user")
        return self._enqueue(
            {"user": None if user is None else int(user),
             "features": features,
             "k": self.k if k is None else int(k),
             "exclude": None if exclude is None else
             list(map(int, exclude))}, req_id)

    def step(self):
        """Score every active request in one batched kernel call."""
        live = [(s, r) for s, r in enumerate(self.active)
                if r is not None]
        self._observe_batch(len(live))
        t_step = self.obs.now()
        rows = []
        for _, req in live:
            if req["user"] is not None:
                rows.append(self.session.user_rows([req["user"]],
                                                   self.block))
            else:
                rows.append(self.session.cold_rows(req["features"],
                                                   self.block))
        batch = torch.cat(rows, dim=0)                # (B, S, K)
        k_max = max(req["k"] for _, req in live)
        excl = [req["exclude"] or [] for _, req in live]
        res = self.session.recommend_rows(batch, k_max, self.block,
                                          exclude=excl)
        # trim each slot to ITS k: the selection picks the same first k
        # entries whatever the total K, so a larger shared batch never
        # changes a request's answer
        for b, (s, req) in enumerate(live):
            kk = min(req["k"], res.ids.shape[1])
            req["ids"] = res.ids[b, :kk].copy()
            req["mean"] = res.mean[b, :kk].copy()
            req["std"] = res.std[b, :kk].copy()
            self._finish(s)
        self.obs.complete("serve/step", t_step, cat="serve",
                          batch=len(live))
