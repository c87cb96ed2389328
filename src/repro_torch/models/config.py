"""Unified model configuration for the assigned architecture pool.

One ``ModelConfig`` covers every family in the pool: dense llama-style
decoders, GQA, MoE (token-choice top-k with optional shared experts),
MLA (DeepSeek compressed-KV attention), Mamba2/SSD blocks, hybrid
attn/ssm interleaves (Jamba), encoder-decoder (Whisper), and stub
modality frontends (ViT patches / audio frames as precomputed
embeddings).

Layers are described as a repeating *pattern* of ``LayerSpec``s; the
reference scans its stacked repeats, the port builds one module per
layer in the same order (prologue, then pattern x repeats).

A copy of ``repro/models/config.py`` (pure Python), kept in the port so
that it imports nothing of the JAX package.  Building a model of a
family the port does not cover yet raises (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating pattern."""

    mixer: str = "attn"        # attn | mla | mamba2
    mlp: str = "dense"         # dense | moe | none  (mamba2 has no mlp)
    window: int = 0            # >0: sliding-window attention
    cross: bool = False        # add cross-attention (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int              # total layer count (pattern * repeats [+ prologue])
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # mlp
    d_ff: int = 0
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_group: int = 1024    # tokens per dispatch group
    # mla (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # mamba2 / ssd
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # structure
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prologue: Tuple[LayerSpec, ...] = ()   # unscanned leading layers
    # enc-dec
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500   # whisper stub frontend length
    # modality frontend stub: inputs arrive as embeddings of this length
    n_frontend_tokens: int = 0   # e.g. ViT patch tokens prepended
    # numerics / misc
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    mlp_gelu: bool = False      # 2-matmul GELU MLP (whisper) vs SwiGLU
    use_layernorm: bool = False  # LayerNorm (whisper) vs RMSNorm
    use_rope: bool = True        # RoPE vs absolute sinusoidal positions
    max_seq_len: int = 8192

    # ------------------------------------------------------------------
    @property
    def repeats(self) -> int:
        n_scanned = self.n_layers - len(self.prologue)
        assert n_scanned % len(self.pattern) == 0, (
            f"{self.name}: {n_scanned} layers not divisible by pattern "
            f"of {len(self.pattern)}")
        return n_scanned // len(self.pattern)

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def validate(self) -> "ModelConfig":
        _ = self.repeats
        for spec in self.pattern + self.prologue:
            if spec.mixer in ("attn",):
                assert self.n_heads and self.head_dim
            if spec.mixer == "mla":
                assert self.kv_lora_rank > 0
            if spec.mixer == "mamba2":
                assert self.ssm_heads > 0
            if spec.mlp == "moe":
                assert self.n_experts and self.top_k
        return self


def param_count(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts, embedding included."""
    D = cfg.d_model
    total = cfg.vocab_size * D  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * D
    active = total

    def attn_params():
        q = D * cfg.n_heads * cfg.head_dim + (
            cfg.n_heads * cfg.head_dim if cfg.qkv_bias else 0)
        kv = 2 * (D * cfg.kv_dim + (cfg.kv_dim if cfg.qkv_bias else 0))
        o = cfg.n_heads * cfg.head_dim * D
        return q + kv + o

    def mla_params():
        # q proj (full), kv down + up, o proj
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        q = D * cfg.n_heads * qd
        kv_down = D * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        kv_up = cfg.kv_lora_rank * cfg.n_heads * (
            cfg.qk_nope_dim + cfg.v_head_dim)
        o = cfg.n_heads * cfg.v_head_dim * D
        return q + kv_down + kv_up + o

    def ssm_params():
        di = cfg.d_inner_ssm
        G = max(1, cfg.ssm_heads // cfg.ssm_heads)  # ngroups=1
        zxbc = D * (2 * di + 2 * G * cfg.ssm_state)
        dt = di // cfg.ssm_head_dim
        out = di * D
        conv = cfg.conv_width * (di + 2 * G * cfg.ssm_state)
        return zxbc + dt + out + conv + 2 * dt  # A_log, D per head

    def mlp_params(kind):
        if kind == "none":
            return 0, 0
        if kind == "dense":
            p = (2 if cfg.mlp_gelu else 3) * D * cfg.d_ff
            return p, p
        # moe: router + experts (+ shared)
        ex = 3 * D * cfg.d_ff_expert
        tot = D * cfg.n_experts + cfg.n_experts * ex \
            + cfg.n_shared_experts * ex
        act = D * cfg.n_experts + cfg.top_k * ex \
            + cfg.n_shared_experts * ex
        return tot, act

    for spec in cfg.prologue + cfg.pattern * cfg.repeats:
        if spec.mixer == "attn":
            p = attn_params()
        elif spec.mixer == "mla":
            p = mla_params()
        else:
            p = ssm_params()
        total += p + 2 * D       # norms
        active += p + 2 * D
        mt, ma = mlp_params(spec.mlp)
        total += mt
        active += ma

    if cfg.is_encoder_decoder:
        # encoder self-attn + GELU mlp; decoder adds cross-attn
        enc = cfg.n_encoder_layers * (attn_params() + 2 * D * cfg.d_ff
                                      + 2 * D)
        cross = cfg.n_layers * attn_params()
        total += enc + cross
        active += enc + cross
    return int(total), int(active)
