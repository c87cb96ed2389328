"""Multi-head Latent Attention (DeepSeek-V2).

The counterpart of ``repro/models/mla.py``.  MLA compresses K/V into a
``kv_lora_rank``-wide latent c_kv plus one ``qk_rope_dim``-wide RoPE
key shared by the heads, so the decode cache holds (rank + rope) values
a position: 512 + 64 for DeepSeek-V2-Lite against 16 * 2 * 192 for
its heads decompressed.

Two forms, as in the reference:

* prefill (no cache) decompresses: k_nope and v from the latents
  through ``kv_b``, the shared RoPE key broadcast over the heads, then
  attention over q and k of width nope + rope (192) against a v of
  width ``v_head_dim`` (128) -- the hand-written two-width flash
  kernels on the card (``csrc/flash_sm90.cu`` in bf16 at 192/128,
  through ``layers.attention_fn``), where the reference runs
  ``chunked_attention``; under autograd its gradient is the two-width
  flash backward (``csrc/flash_bwd_sm90.cu``), and dv flows back
  through the strided view of v into the ``kv_b`` product;
* decode (a cache) runs the absorbed form in plain PyTorch, as the
  reference does outside any Pallas kernel: q_nope mapped through W_UK
  into latent space, fp32 scores against the cached latents and RoPE
  keys, the weighted sum of latents mapped out through W_UV.

The cache is ``{"c_kv": (B, max_len, rank), "k_rope": (B, max_len,
rope), "len"}`` in the compute dtype, updated in place (the reference
returns new arrays) at slot ``min(len, max_len - S)``, where the
reference's ``dynamic_update_slice`` clamps its start.  The reference
masks the positions >= len + 1 of the whole cache (weight exactly 0
after its -1e30 mask); here they are cut off, the same function, so
that a step's arithmetic does not depend on the cache's length and a
server and ``generate`` with other cache sizes give the same bits.

The absorbed decode serves only and is never differentiated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .layers import (Dense, Params, RMSNorm, _dense, apply_rope,
                     attention_fn, cdtype, init_rmsnorm, rms_norm)


class MLA(nn.Module):
    """``wq``, ``kv_a``, ``kv_norm``, ``kv_b``, ``wo``."""

    def __init__(self, wq: Dense, kv_a: Dense, kv_norm: RMSNorm,
                 kv_b: Dense, wo: Dense):
        super().__init__()
        self.wq, self.kv_a, self.kv_norm, self.kv_b, self.wo = \
            wq, kv_a, kv_norm, kv_b, wo


def init_mla(gen: torch.Generator, cfg: ModelConfig, device=None,
             dtype=None) -> MLA:
    D, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    kw = dict(dtype=dtype or cdtype(cfg), device=device)
    return MLA(Dense(_dense(gen, D, D, H * (dn + dr), **kw)),
               Dense(_dense(gen, D, D, r + dr, **kw)),
               init_rmsnorm(r, device),
               Dense(_dense(gen, r, r, H * (dn + dv), **kw)),
               Dense(_dense(gen, H * dv, H * dv, D, **kw)))


def apply_mla(p: MLA, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[Params] = None
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, D) -> (y (B, S, D), new cache or None).  Without a cache
    the whole sequence from position 0 (prefill); with one, positions
    from ``cache["len"]`` (decode), returning the cache with ``len +
    1``."""
    dt = cdtype(cfg)
    B, S, _ = x.shape
    H = cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    scale = 1.0 / np.sqrt(dn + dr)

    q = torch.matmul(x, p.wq.w.to(dt)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = torch.matmul(x, p.kv_a.w.to(dt))
    c_kv = rms_norm(p.kv_norm, kv[..., :r], cfg.norm_eps)
    k_rope = kv[..., r:]

    cur = None if cache is None else int(cache["len"])
    if cur is None:
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device)[None].expand(B, S)
    else:
        pos = torch.full((B, S), cur, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], pos, cfg.rope_theta)[..., 0, :]

    wkv_b = p.kv_b.w.to(dt)                        # (r, H * (dn + dv))
    if cache is None:
        # decompress: k_nope and v from one product with kv_b, read as
        # strided views; the shared RoPE key broadcast over the heads
        kvd = torch.matmul(c_kv, wkv_b).reshape(B, S, H, dn + dv)
        k = torch.cat([kvd[..., :dn],
                       k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = attention_fn(qf, k, kvd[..., dn:], causal=True)
        new_cache = None
    else:
        w3 = wkv_b.reshape(r, H, dn + dv)
        wk_b, wv_b = w3[..., :dn], w3[..., dn:]
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        slot = max(0, min(cur, ckv_c.shape[1] - S))
        ckv_c[:, slot:slot + S] = c_kv.to(ckv_c.dtype)
        kr_c[:, slot:slot + S] = k_rope.to(kr_c.dtype)
        new_cache = {"c_kv": ckv_c, "k_rope": kr_c, "len": cur + 1}
        n = min(cur + 1, ckv_c.shape[1])
        ckv = ckv_c[:, :n].to(torch.float32)
        # q_nope (B, S, H, dn) through W_UK -> latent-space queries
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)
        scores = (torch.einsum("bshr,btr->bhst", q_lat.to(torch.float32),
                               ckv)
                  + torch.einsum("bshd,btd->bhst",
                                 q_rope.to(torch.float32),
                                 kr_c[:, :n].to(torch.float32))) * scale
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", w, ckv)        # (B, S, H, r)
        out = torch.einsum("bshr,rhd->bshd", ctx.to(dt), wv_b)

    y = torch.matmul(out.reshape(B, S, H * dv), p.wo.w.to(dt))
    return y, new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> Params:
    kw = dict(dtype=cdtype(cfg), device=device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), **kw),
            "len": 0}
