"""Serving: the slot/queue runtime and the recommendation service.

The counterpart of ``SlotServer`` and ``RecommendServer`` in
``repro/launch/serve.py``.  Requests queue, free slots admit them, and
one service step advances every active slot at once:
:class:`RecommendServer` scores all admitted requests in one
``kernels.ops.topk_score`` call (the hand-written CUDA kernel on the
card) against the resident posterior cache of a
:class:`~repro_torch.core.predict.PredictSession`.  Batching changes no
answer: each query runs one identical float program whatever the
batch, so results are bitwise equal to sequential
``PredictSession.recommend`` calls.

The store is loaded once, when the server is built (``warm_cache``);
request paths never touch the checkpoint loader.  ``BatchedServer``
and the LM decode steps of the reference belong to the LM substrate
(ROADMAP A10) and are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import Recorder, clock, integer_buckets


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
    (``features=``) need the Macau prior (ROADMAP A5) and raise when
    they are served.
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
