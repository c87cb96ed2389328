"""Token-choice top-k Mixture-of-Experts (GShard/Switch-style).

The counterpart of ``repro/models/moe.py``, with its capacity-bounded
masked-einsum dispatch: tokens are split into groups of
``router_group``; within a group each expert takes at most C =
max(4, min(ceil(k * group * capacity_factor / E), group)) tokens, and
the (token, slot) pairs past an expert's capacity are dropped.  An
expert's slots go to its tokens in token-major, slot-minor order (a
cumsum over the group's (G * k, E) one-hots), which decides who is
dropped; a token's slot therefore depends on the other tokens of its
group, at decode (a group of the batch's B tokens) as at prefill.

The router, the top-k gates and the dispatch and combine tensors are
fp32, as in the reference; the router's weight is held in fp32 by a
serving model too (the reference reads its fp32 master there), every
other weight in the compute dtype.  The top-k takes, among equal
probabilities, the lowest expert first (``jax.lax.top_k``'s order,
through a stable sort).  The expert products are batched matmuls in the
compute dtype; the reference leaves all of it to XLA (no Pallas
kernel), so none of it is a hand-written kernel here.

Shared experts (DeepSeek-V2) run densely on every token.  Returns the
aux losses (Switch load balance, ST-MoE router z-loss) for the
transformer to sum.  The reference's expert-parallel sharding (its
``mesh`` and ``ep`` flag) has no single-card meaning and is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Dense, _dense, cdtype


class MoE(nn.Module):
    """``router`` (fp32), ``experts_gate``, ``experts_in``,
    ``experts_down`` (E, ., .), and with shared experts ``shared_gate``,
    ``shared_in``, ``shared_down``."""

    def __init__(self, router: Dense, experts_gate: Dense, experts_in: Dense,
                 experts_down: Dense, shared_gate: Optional[Dense] = None,
                 shared_in: Optional[Dense] = None,
                 shared_down: Optional[Dense] = None):
        super().__init__()
        self.router = router
        self.experts_gate, self.experts_in, self.experts_down = \
            experts_gate, experts_in, experts_down
        self.shared_gate, self.shared_in, self.shared_down = \
            shared_gate, shared_in, shared_down


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None,
             dtype=None) -> MoE:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    kw = dict(dtype=dtype or cdtype(cfg), device=device)
    p = MoE(Dense(_dense(gen, D, D, E, dtype=torch.float32, device=device)),
            Dense(_dense(gen, D, E, D, Fe, **kw)),
            Dense(_dense(gen, D, E, D, Fe, **kw)),
            Dense(_dense(gen, Fe, E, Fe, D, **kw)))
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        p.shared_gate = Dense(_dense(gen, D, D, Fs, **kw))
        p.shared_in = Dense(_dense(gen, D, D, Fs, **kw))
        p.shared_down = Dense(_dense(gen, Fs, Fs, D, **kw))
    return p


def capacity(cfg: ModelConfig, T: int) -> Tuple[int, int]:
    """(group size G, expert capacity C) for T tokens."""
    G = min(cfg.router_group, T)
    assert T % G == 0, f"tokens {T} not divisible by group {G}"
    C = int(np.ceil(cfg.top_k * G * cfg.capacity_factor / cfg.n_experts))
    return G, max(4, min(C, G))


def route(router_w: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor):
    """The router on grouped tokens xt (n, G, D) -> dict of fp32 tensors:
    ``logits`` and ``probs`` (n, G, E), ``gates`` (n, G, k) renormalised,
    ``onehot`` (n, G, k, E) of the chosen experts, ``dispatch`` and
    ``combine`` (n, G, E, C): token g's place in slot c of expert e (1.0)
    and its gate there."""
    n, G, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    _, C = capacity(cfg, n * G)
    logits = torch.einsum("ngd,de->nge", xt.to(torch.float32),
                          router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # top-k, ties to the lowest expert as jax.lax.top_k
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[..., :K], order[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(idx, E).to(torch.float32)           # (n, G, K, E)
    flat = onehot.reshape(n, G * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n, G, K, E)
    keep = (pos < C).to(torch.float32) * onehot
    # one-hot over the capacity slot, a zero row where pos >= C (as
    # jax.nn.one_hot): how an overflowing (token, slot) is dropped
    slot = (pos[..., None] == torch.arange(
        C, dtype=torch.float32, device=xt.device)).to(torch.float32)
    dispatch = torch.einsum("ngke,ngkec->ngec", keep, slot)
    combine = torch.einsum("ngk,ngke,ngkec->ngec", gates, keep, slot)
    return {"logits": logits, "probs": probs, "gates": gates,
            "onehot": onehot, "dispatch": dispatch, "combine": combine}


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, {"lb_loss",
    "z_loss"} fp32 0-d)."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G, _ = capacity(cfg, B * S)
    xt = x.reshape(-1, G, D)
    r = route(p.router.w, cfg, xt)

    # expert inputs (n, E, C, D): each slot holds one token or zeros
    ein = torch.einsum("ngec,ngd->necd", r["dispatch"],
                       xt.to(torch.float32)).to(dt)
    g = torch.einsum("necd,edf->necf", ein, p.experts_gate.w.to(dt))
    h = torch.einsum("necd,edf->necf", ein, p.experts_in.w.to(dt))
    eout = torch.einsum("necf,efd->necd", F.silu(g) * h,
                        p.experts_down.w.to(dt))
    out = torch.einsum("ngec,necd->ngd", r["combine"],
                       eout.to(torch.float32))
    out = out.reshape(B, S, D).to(dt)

    if cfg.n_shared_experts:
        sg = torch.matmul(x, p.shared_gate.w.to(dt))
        sh = torch.matmul(x, p.shared_in.w.to(dt))
        out = out + torch.matmul(F.silu(sg) * sh, p.shared_down.w.to(dt))

    frac_tokens = torch.mean(r["onehot"].sum(2), dim=(0, 1))      # (E,)
    frac_probs = torch.mean(r["probs"], dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs) / max(K, 1)
    z_loss = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)
    return out, {"lb_loss": lb_loss, "z_loss": z_loss}
