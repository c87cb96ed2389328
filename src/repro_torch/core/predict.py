"""Posterior-predictive evaluation over collected samples, and serving.

The counterpart of ``repro/core/predict.py``.  In a session:
``TestSet``, ``make_test_set``, ``predict_one``, ``rmse`` and
``PredictAccumulator`` average per-sample predictions into the
posterior mean.

From disk: :class:`PredictSession` reloads the posterior samples a
session streamed out (``save_freq``/``save_dir``, in either package's
store layout) and serves averaged predictions and top-K
recommendations without the training data.  The first request loads
the store once into the resident :class:`PosteriorCache` -- ``(S, N,
K)`` factor stacks on the session's device -- bounded by
``cache_bytes`` (env ``REPRO_PREDICT_CACHE_BYTES``, default 1 GiB);
every later request performs zero checkpoint loads.  Stores above the
budget keep the reference's lazy path, which streams the samples from
disk per request.  ``recommend``/``recommend_rows`` rank items by
posterior mean, with the posterior std beside each score, through
``kernels.ops.topk_score`` (the hand-written CUDA kernel on the card);
``launch.serve.RecommendServer`` batches requests onto them.

Out-of-matrix prediction (``predict_new``, ``cold_rows``) needs the
Macau prior, which is not ported yet (ROADMAP A5): every entity of a
port's store has a ``NormalPrior``, and those calls raise the
reference's ValueError.
"""
from __future__ import annotations

import os
import warnings
from collections import OrderedDict
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels import ops


class TestSet(NamedTuple):
    i: torch.Tensor   # (E,) int32 row ids
    j: torch.Tensor   # (E,) int32 col ids
    v: torch.Tensor   # (E,) f32 true values


def make_test_set(i, j, v, device: DeviceLike = None) -> TestSet:
    dev = resolve_device(device)
    return TestSet(torch.as_tensor(np.asarray(i, np.int32), device=dev),
                   torch.as_tensor(np.asarray(j, np.int32), device=dev),
                   torch.as_tensor(np.asarray(v, np.float32), device=dev))


def predict_one(U: torch.Tensor, V: torch.Tensor, test: TestSet
                ) -> torch.Tensor:
    """Single-sample prediction at the test entries."""
    return ops.sddmm(U.index_select(0, test.i), V.index_select(0, test.j))


def rmse(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred - truth) ** 2))


class PredictAccumulator:
    """Streaming average of per-sample predictions (posterior mean)."""

    def __init__(self, test: TestSet):
        self.test = test
        self._sum = torch.zeros_like(test.v)
        self._sum2 = torch.zeros_like(test.v)
        self.n = 0

    def update(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        p = predict_one(U, V, self.test)
        self._sum = self._sum + p
        self._sum2 = self._sum2 + p * p
        self.n += 1
        return p

    @property
    def mean(self) -> torch.Tensor:
        return self._sum / max(self.n, 1)

    @property
    def var(self) -> torch.Tensor:
        """Population variance over the posterior samples of the
        per-sample predictions, ``E[p^2] - E[p]^2``."""
        m = self.mean
        return torch.clamp_min(self._sum2 / max(self.n, 1) - m * m, 0.0)

    def rmse(self) -> float:
        return float(rmse(self.mean, self.test.v))


# ---------------------------------------------------------------------------
# from-disk prediction over saved posterior samples
# ---------------------------------------------------------------------------

# model.json specs keyed by realpath -> (mtime, spec): every
# PredictSession over one store shares one parsed spec; mtime
# invalidates an entry whose file was rewritten.  Bounded LRU.
_SPEC_CACHE: "OrderedDict[str, Tuple[float, dict]]" = OrderedDict()
_SPEC_CACHE_MAX = 64
_SPEC_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}

DEFAULT_CACHE_BYTES = 1 << 30    # 1 GiB of stacked posterior samples


def spec_cache_stats() -> dict:
    """Counters + occupancy of the module-level model.json spec cache
    (part of ``PredictSession.cache_stats()``)."""
    out = dict(_SPEC_CACHE_STATS)
    out["size"] = len(_SPEC_CACHE)
    out["max_size"] = _SPEC_CACHE_MAX
    return out


def _load_spec_cached(path: str) -> dict:
    from .modelspec import load_model_spec
    try:
        key = os.path.realpath(path)
        mtime = os.path.getmtime(path)
    except OSError:
        # missing file: fall through for the helpful error message
        return load_model_spec(path)
    hit = _SPEC_CACHE.get(key)
    if hit is not None and hit[0] == mtime:
        _SPEC_CACHE_STATS["hits"] += 1
        _SPEC_CACHE.move_to_end(key)
        return hit[1]
    _SPEC_CACHE_STATS["misses"] += 1
    spec = load_model_spec(path)
    _SPEC_CACHE[key] = (mtime, spec)
    _SPEC_CACHE.move_to_end(key)
    while len(_SPEC_CACHE) > _SPEC_CACHE_MAX:
        _SPEC_CACHE.popitem(last=False)
        _SPEC_CACHE_STATS["evictions"] += 1
    return spec


def _resolve_cache_bytes(cache_bytes: Optional[int]) -> int:
    if cache_bytes is not None:
        return int(cache_bytes)
    env = os.environ.get("REPRO_PREDICT_CACHE_BYTES")
    return int(env) if env else DEFAULT_CACHE_BYTES


class PosteriorCache(NamedTuple):
    """The whole sample store, resident on the session's device.

    ``factors[e]`` stacks entity ``e``'s sampled factor over the
    retained chain, shape ``(S, N_e, K)``: the item operand of
    ``ops.topk_score``.  ``hypers[e]`` stacks the prior's hyper dict the
    same way (a leading ``S`` axis per leaf).
    """

    factors: Tuple[torch.Tensor, ...]
    hypers: Tuple[Dict[str, torch.Tensor], ...]
    n_samples: int

    def hyper_at(self, entity: int, s: int) -> Dict[str, torch.Tensor]:
        """Entity ``entity``'s hyper dict of retained sample ``s``."""
        return {k: x[s] for k, x in self.hypers[entity].items()}

    def nbytes(self) -> int:
        """Actual resident bytes of the stacked cache (all leaves)."""
        leaves = list(self.factors) + [x for h in self.hypers
                                       for x in h.values()]
        return sum(x.numel() * x.element_size() for x in leaves)


class RecResult(NamedTuple):
    """Batched top-K recommendations with posterior uncertainty.

    ``ids[b, r]`` is the r-th ranked item for query ``b`` (-1 past the
    number of rankable items), ``mean``/``std`` the posterior mean and
    standard deviation of its score over the retained samples (NaN on
    -1 slots).
    """

    ids: np.ndarray     # (B, k) int32
    mean: np.ndarray    # (B, k) float32
    std: np.ndarray     # (B, k) float32


class PredictSession:
    """Serve averaged predictions from a saved posterior-sample store.

    ``save_dir`` is a directory written by a session with
    ``save_freq > 0`` (of this package or of ``repro``): a
    ``model.json`` spec plus ``samples/step_<sweep>`` checkpoints, each
    one full sampled ``MFState``; a multi-chain store nests one such
    store per chain under ``chain_<c>/``, and its samples are pooled
    step-major, chain-minor (the in-session accumulation order).
    ``device`` (default: the card) holds the resident cache and runs
    every prediction.

    * ``predict(i, j, block=...)``: posterior mean at cells of a block,
      the in-session accumulator's float program (one ``predict_one``
      per sample, summed in chain order);
    * ``predict_all(block=...)``: the whole block's posterior mean;
    * ``recommend(user=..., k=...)`` / ``recommend_rows``: top-K items
      by posterior mean with the posterior std of each score;
    * ``restore_latest()``: (step, MFState) of the newest sample.

    The first prediction loads the store once into the resident
    :class:`PosteriorCache` when ``store_nbytes()`` fits ``cache_bytes``;
    ``load_count`` counts checkpoint loads and stays flat across repeat
    requests.  Larger stores keep the lazy path, which streams one
    sample at a time from disk.  ``require_converged=True`` refuses a
    store whose ``diagnostics.json`` records a split-R-hat above
    ``rhat_threshold`` (or that records none); ``"warn"`` warns instead.
    """

    def __init__(self, save_dir: str,
                 cache_bytes: Optional[int] = None,
                 require_converged: Union[bool, str] = False,
                 rhat_threshold: Optional[float] = None,
                 recorder: Any = None, device: DeviceLike = None):
        from ..checkpoint.ckpt import list_steps
        from ..obs import resolve_recorder
        from .diagnostics import load_diagnostics
        from .modelspec import (MODEL_SPEC_FILE, SAMPLES_SUBDIR,
                                chain_count_on_disk, chain_subdir,
                                spec_to_model, state_template)
        self.device = resolve_device(device)
        self.dir = save_dir
        self.spec = _load_spec_cached(os.path.join(save_dir,
                                                   MODEL_SPEC_FILE))
        self.model = spec_to_model(self.spec, device=self.device)
        self._template = state_template(self.model)
        chains_on_disk = chain_count_on_disk(save_dir)
        self.n_chains = max(1, chains_on_disk)
        if chains_on_disk == 0:
            self._sample_dirs = [os.path.join(save_dir, SAMPLES_SUBDIR)]
        else:
            self._sample_dirs = [
                os.path.join(save_dir, chain_subdir(c), SAMPLES_SUBDIR)
                for c in range(chains_on_disk)]
        self._samples_dir = self._sample_dirs[0]
        per_chain = [list_steps(d) for d in self._sample_dirs]
        # pooled (step, chain) ids, step-major chain-minor
        self.chain_steps: List[Tuple[int, int]] = sorted(
            (s, c) for c, steps in enumerate(per_chain) for s in steps)
        self.steps: List[int] = sorted({s for s, _ in self.chain_steps})
        if not self.chain_steps:
            raise ValueError(
                f"no complete samples under {self._samples_dir}; run "
                "the session with save_freq > 0 (and let at least one "
                "post-burnin sweep finish)")
        self._step_sets = [frozenset(s) for s in per_chain]
        self.cache_bytes = _resolve_cache_bytes(cache_bytes)
        self.load_count = 0          # checkpoint loads, ever
        self._cache: Optional[PosteriorCache] = None
        self.obs = resolve_recorder(recorder)
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_over_budget = 0
        self.diagnostics = load_diagnostics(save_dir)
        if require_converged:
            self._check_converged(require_converged, rhat_threshold)

    def _check_converged(self, mode: Union[bool, str],
                         rhat_threshold: Optional[float]) -> None:
        from .diagnostics import DEFAULT_RHAT_THRESHOLD
        threshold = (DEFAULT_RHAT_THRESHOLD if rhat_threshold is None
                     else float(rhat_threshold))
        if self.diagnostics is None:
            msg = (
                f"require_converged: store {self.dir!r} records no "
                "diagnostics.json — it predates convergence recording "
                "or the training run died before finishing; rerun the "
                "session (ideally chains>=2) to record split-R-hat/"
                "bulk-ESS, or serve explicitly ungated with "
                "require_converged=False")
        else:
            failing = self.diagnostics.failing(threshold)
            if not failing:
                return
            worst = ", ".join(f"{k}={v:.4g}"
                              for k, v in sorted(failing.items()))
            msg = (
                f"require_converged: store {self.dir!r} has NOT "
                f"converged — split-R-hat over "
                f"{self.diagnostics.n_chains} chain(s) x "
                f"{self.diagnostics.n_draws} draws exceeds "
                f"{threshold:g} for: {worst}. Run more sweeps/chains, "
                "raise rhat_threshold deliberately, or serve "
                "explicitly ungated with require_converged=False")
        if mode == "warn":
            warnings.warn(msg, stacklevel=3)
        else:
            raise ValueError(msg)

    # -- sample access -----------------------------------------------------

    @property
    def num_samples(self) -> int:
        """Pooled sample count, across all chains of the store."""
        return len(self.chain_steps)

    def _load(self, step: int, chain: int, device):
        from ..checkpoint.ckpt import load_pytree
        if not 0 <= chain < self.n_chains:
            raise ValueError(
                f"no chain {chain}; this store holds "
                f"{self.n_chains} chain(s)")
        if step not in self._step_sets[chain]:
            saved = ", ".join(map(str, sorted(self._step_sets[chain])))
            raise ValueError(
                f"no sample at step {step}"
                + (f" for chain {chain}" if self.n_chains > 1 else "")
                + f"; saved steps: {saved}")
        self.load_count += 1
        return load_pytree(self._template,
                           os.path.join(self._sample_dirs[chain],
                                        f"step_{step}"), device)

    def load_sample(self, step: int, chain: int = 0):
        """The full sampled ``MFState`` saved at global sweep ``step``
        (of ``chain``, for a multi-chain store), on the session's
        device."""
        return self._load(step, chain, self.device)

    def samples(self) -> Iterator:
        """Lazily yield every sampled state, pooled step-major
        chain-minor (the in-session accumulation order)."""
        for s, c in self.chain_steps:
            yield self.load_sample(s, c)

    def restore_latest(self) -> Tuple[int, object]:
        """(step, MFState) of the newest sample of chain 0."""
        last = max(self._step_sets[0])
        return last, self.load_sample(last, 0)

    # -- resident posterior cache ------------------------------------------

    def store_nbytes(self) -> int:
        """Resident size of the FULL stacked store, from the state
        template (every leaf of a sample, in its on-disk type, times
        the number of samples), computed without loading it."""
        t = self._template
        leaves = list(t.factors) + [x for d in t.hypers + t.noises
                                    for x in d.values()]
        per_sample = 2 * 4 + 4     # the uint32 key and the int32 step
        per_sample += sum(x.numel() * x.element_size() for x in leaves)
        return per_sample * self.num_samples

    @property
    def cache_resident(self) -> bool:
        return self._cache is not None

    def warm_cache(self) -> Optional[PosteriorCache]:
        """Load the store once into the resident cache (idempotent).

        Returns the cache, or None when the store exceeds
        ``cache_bytes``; callers then stream samples lazily.  The
        samples are stacked on the host and cross to the device once.
        """
        if self._cache is not None:
            self._cache_hits += 1
            self.obs.add("predict.cache_hit")
            return self._cache
        self._cache_misses += 1
        self.obs.add("predict.cache_miss")
        if self.store_nbytes() > self.cache_bytes:
            # all-or-nothing: there is no partial residency
            self._cache_over_budget += 1
            self.obs.add("predict.cache_over_budget")
            return None
        n_ent = len(self.model.entities)
        with self.obs.span("predict/warm_cache", cat="predict",
                           samples=self.num_samples):
            fac: List[List[torch.Tensor]] = [[] for _ in range(n_ent)]
            hyp: List[List[Dict[str, torch.Tensor]]] = [
                [] for _ in range(n_ent)]
            for s, c in self.chain_steps:
                st = self._load(s, c, "cpu")
                for e in range(n_ent):
                    fac[e].append(st.factors[e])
                    hyp[e].append(st.hypers[e])
            factors = tuple(torch.stack(f).to(self.device) for f in fac)
            hypers = tuple({k: torch.stack([d[k] for d in h]).to(
                self.device) for k in h[0]} for h in hyp)
            self._cache = PosteriorCache(factors, hypers,
                                         self.num_samples)
        self.obs.gauge("predict.cache_resident_bytes",
                       self._cache.nbytes())
        return self._cache

    def cache_stats(self) -> dict:
        """Counters of the resident posterior cache and of the module's
        spec cache.  ``hits``/``misses`` count ``warm_cache()`` calls: a
        miss is the first load or an over-budget refusal."""
        return {
            "hits": self._cache_hits,
            "misses": self._cache_misses,
            "over_budget": self._cache_over_budget,
            "resident": self._cache is not None,
            "resident_bytes": (self._cache.nbytes()
                               if self._cache is not None else 0),
            "budget_bytes": self.cache_bytes,
            "load_count": self.load_count,
            "spec_cache": spec_cache_stats(),
        }

    def _factor_iter(self, entity: int) -> Iterator[torch.Tensor]:
        """Entity factors per retained sample: from the cache when
        resident (zero loads), streamed from disk otherwise."""
        cache = self.warm_cache()
        if cache is not None:
            for s in range(cache.n_samples):
                yield cache.factors[entity][s]
        else:
            for st in self.samples():
                yield st.factors[entity]

    def _factor_pair_iter(self, ent_a: int, ent_b: int):
        cache = self.warm_cache()
        if cache is not None:
            for s in range(cache.n_samples):
                yield (cache.factors[ent_a][s],
                       cache.factors[ent_b][s])
        else:
            for st in self.samples():
                yield st.factors[ent_a], st.factors[ent_b]

    # -- block/entity resolution -------------------------------------------

    def _resolve_block(self, block: Union[int, Tuple[str, str]]
                       ) -> Tuple[int, bool]:
        """(block_index, flipped): ``flipped`` means the caller named
        the pair in the OPPOSITE order to the block's stored
        orientation.  An integer block addresses the stored one."""
        model = self.model
        if isinstance(block, tuple):
            a = model.entity_index(block[0])
            b = model.entity_index(block[1])
            for bi, blk in enumerate(model.blocks):
                if (blk.row_entity, blk.col_entity) == (a, b):
                    return bi, False
                if (blk.row_entity, blk.col_entity) == (b, a):
                    return bi, True
            names = model.entity_names
            pairs = ", ".join(
                f"({names[blk.row_entity]}, {names[blk.col_entity]})"
                for blk in model.blocks)
            raise ValueError(
                f"no block relates {block!r}; blocks in this model: "
                f"{pairs}")
        bi = int(block)
        if not 0 <= bi < len(model.blocks):
            raise ValueError(
                f"block index {bi} out of range; this model has "
                f"{len(model.blocks)} blocks")
        return bi, False

    # -- prediction --------------------------------------------------------

    def predict(self, i, j, block: Union[int, Tuple[str, str]] = 0,
                return_var: bool = False):
        """Posterior-mean prediction at cells (i[e], j[e]) of a block:
        the in-session accumulator's float program, so a reload
        reproduces the in-session posterior mean, and the cached and
        lazy paths are bitwise equal.  A tuple ``block`` addresses
        (i, j) in the order the tuple names the entities."""
        bi, flipped = self._resolve_block(block)
        blk = self.model.blocks[bi]
        if flipped:
            i, j = j, i
        i = np.asarray(i)
        test = make_test_set(i, j, np.zeros(i.shape[0], np.float32),
                             device=self.device)
        acc = PredictAccumulator(test)
        for u, v in self._factor_pair_iter(blk.row_entity,
                                           blk.col_entity):
            acc.update(u, v)
        if return_var:
            return acc.mean.cpu().numpy(), acc.var.cpu().numpy()
        return acc.mean.cpu().numpy()

    def predict_all(self, block: Union[int, Tuple[str, str]] = 0
                    ) -> np.ndarray:
        """The whole block's posterior-mean prediction; axes follow the
        order a tuple ``block`` names the entities in."""
        bi, flipped = self._resolve_block(block)
        blk = self.model.blocks[bi]
        s = None
        for u, v in self._factor_pair_iter(blk.row_entity,
                                           blk.col_entity):
            p = u @ v.T
            s = p if s is None else s + p
        out = (s / self.num_samples).cpu().numpy()
        return out.T if flipped else out

    def _needs_macau(self, e: int, what: str) -> ValueError:
        ent = self.model.entities[e]
        return ValueError(
            f"entity {ent.name!r} has {type(ent.prior).__name__}{what}")

    def predict_new(self, entity: Union[int, str], F_new,
                    block: Optional[Union[int, Tuple[str, str]]] = None
                    ) -> np.ndarray:
        """Out-of-matrix prediction for unseen rows: needs the Macau
        prior, which the port does not have yet (ROADMAP A5), so it
        raises the reference's error for every entity."""
        e = self.model.entity_index(entity)
        raise self._needs_macau(
            e, "; out-of-matrix prediction needs the Macau "
            "side-information prior (its sampled beta link maps new "
            "feature rows to latents) — add_entity(..., side_info=F)")

    # -- batched top-K recommendation (the serving path) -------------------

    def _block_entities(self, block: Union[int, Tuple[str, str]]
                        ) -> Tuple[int, int]:
        """(user_entity, item_entity) of ``block``: a tuple block names
        (users, items) in that order; an integer block ranks the column
        entity's rows as items."""
        bi, flipped = self._resolve_block(block)
        blk = self.model.blocks[bi]
        if flipped:
            return blk.col_entity, blk.row_entity
        return blk.row_entity, blk.col_entity

    def user_rows(self, users: Sequence[int],
                  block: Union[int, Tuple[str, str]] = 0
                  ) -> torch.Tensor:
        """Sampled latent rows of warm users: (B, S, K), gathered from
        the resident cache (zero loads) or streamed from disk once."""
        ue, _ = self._block_entities(block)
        users = np.asarray(users, np.int64)
        n_rows = self.model.entities[ue].n_rows
        bad = users[(users < 0) | (users >= n_rows)]
        if bad.size:
            raise ValueError(
                f"user row(s) {bad.tolist()} out of range for entity "
                f"{self.model.entities[ue].name!r} with {n_rows} rows;"
                " unseen rows are served via features= (cold start)")
        idx = torch.as_tensor(users, device=self.device)
        cache = self.warm_cache()
        if cache is not None:
            # (S, B, K) -> (B, S, K)
            return cache.factors[ue].index_select(1, idx).transpose(
                0, 1).contiguous()
        rows = [f.index_select(0, idx) for f in self._factor_iter(ue)]
        return torch.stack(rows, dim=1)

    def cold_rows(self, F_new,
                  block: Union[int, Tuple[str, str]] = 0
                  ) -> torch.Tensor:
        """Sampled latent rows for unseen users through the Macau link:
        not ported yet (ROADMAP A5); raises the reference's error."""
        ue, _ = self._block_entities(block)
        raise self._needs_macau(
            ue, "; cold-start recommendation needs the Macau "
            "side-information prior — add_entity(..., side_info=F)")

    def _exclude_mask(self, exclude, B: int, n_items: int):
        """Per-query excluded item ids -> (B, n_items) f32 mask."""
        if exclude is None:
            return None
        mask = np.zeros((B, n_items), np.float32)
        if len(exclude) != B:
            raise ValueError(
                f"exclude has {len(exclude)} entries for {B} queries;"
                " pass one id-sequence (possibly empty) per query")
        for b, ids in enumerate(exclude):
            ids = np.asarray(ids, np.int64)
            if ids.size:
                if ids.min() < 0 or ids.max() >= n_items:
                    raise ValueError(
                        f"exclude ids for query {b} outside "
                        f"[0, {n_items})")
                mask[b, ids] = 1.0
        return mask

    def recommend_rows(self, rows, k: int = 10,
                       block: Union[int, Tuple[str, str]] = 0,
                       exclude=None) -> RecResult:
        """Top-K items for pre-resolved query rows (B, S, K).

        The batched serving primitive: ``ops.topk_score`` scores every
        query against the item factor stack across all retained
        samples, one identical float program per query, so a batched
        call is bitwise equal to one call per query.  ``exclude``: one
        sequence of item ids per query left out of the ranking.
        """
        rows = torch.as_tensor(rows, device=self.device)
        if rows.dim() != 3:
            raise ValueError(
                f"rows must be (B, S, K), got {tuple(rows.shape)}; "
                "build them with user_rows()/cold_rows()")
        _, ie = self._block_entities(block)
        n_items = self.model.entities[ie].n_rows
        mask = self._exclude_mask(exclude, rows.shape[0], n_items)
        if mask is not None:
            mask = torch.from_numpy(mask).to(self.device)
        cache = self.warm_cache()
        if cache is not None:
            ids, mean, std = ops.topk_score(rows, cache.factors[ie], k,
                                            exclude=mask)
            return RecResult(ids.cpu().numpy(), mean.cpu().numpy(),
                             std.cpu().numpy())
        return self._recommend_rows_lazy(rows, k, ie, mask)

    def _recommend_rows_lazy(self, rows, k, item_entity, mask
                             ) -> RecResult:
        """Over-budget path: stream the store once, accumulating per-item
        score moments, then select like the reference.  Statistically
        the cached path's answer; the summation order differs, so
        near-ties may rank differently."""
        B, S, _ = rows.shape
        mean_sum = None
        ex2_sum = None
        for s, v in enumerate(self._factor_iter(item_entity)):
            p = rows[:, s, :] @ v.T                       # (B, N)
            mean_sum = p if mean_sum is None else mean_sum + p
            p2 = p * p
            ex2_sum = p2 if ex2_sum is None else ex2_sum + p2
        inv_s = torch.ones((), dtype=torch.float32,
                           device=self.device) / S
        mean = mean_sum * inv_s
        ex2 = ex2_sum * inv_s
        std = torch.sqrt(torch.clamp_min(ex2 - mean * mean, 0.0))
        excl = torch.zeros_like(mean) if mask is None else mask
        rank = torch.where(excl > 0, -torch.inf, mean)
        k_eff = min(int(k), rank.shape[1])
        order = torch.sort(-rank, dim=1, stable=True).indices[:, :k_eff]
        sel_mean = torch.gather(mean, 1, order)
        sel_std = torch.gather(std, 1, order)
        n_valid = torch.sum(excl <= 0, dim=1)
        bad = torch.arange(k_eff, device=self.device)[None, :] \
            >= n_valid[:, None]
        return RecResult(
            torch.where(bad, -1, order).to(torch.int32).cpu().numpy(),
            torch.where(bad, torch.nan, sel_mean).cpu().numpy(),
            torch.where(bad, torch.nan, sel_std).cpu().numpy())

    def recommend(self, user: Optional[Union[int, Sequence[int]]]
                  = None, *, features=None, k: int = 10,
                  block: Union[int, Tuple[str, str]] = 0,
                  exclude=None) -> RecResult:
        """Top-K recommendation for warm users (row ids seen in
        training).  ``features`` (cold start) needs the Macau prior and
        raises until it is ported.  ``exclude`` follows
        ``recommend_rows`` (for a single query, a flat id list is
        accepted)."""
        parts = []
        n_q = 0
        if user is not None:
            users = np.atleast_1d(np.asarray(user, np.int64))
            parts.append(self.user_rows(users, block))
            n_q += users.shape[0]
        if features is not None:
            cold = self.cold_rows(features, block)
            parts.append(cold)
            n_q += cold.shape[0]
        if not parts:
            raise ValueError(
                "pass user= (warm row ids) and/or features= "
                "(cold-start side info)")
        if exclude is not None and n_q == 1:
            # single-query convenience: a flat id list, or an empty one
            ex = list(exclude)
            if not ex or np.ndim(ex[0]) == 0:
                exclude = [ex]
        rows = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        return self.recommend_rows(rows, k, block, exclude)
