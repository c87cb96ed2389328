"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attn 7:1 interleave
[arXiv:2403.19887].

Pattern (period 8, matching the paper's Jamba block): attention at
index 3, Mamba elsewhere; MoE replaces the MLP on every other layer
(odd indices).  Jamba-v0.1 uses Mamba-1 internally; we implement the
mixer as a Mamba-2/SSD block (state 16, head_dim 64, d_inner 8192 ->
128 heads) — the TPU-native chunked-dual form; noted in DESIGN.md
§Hardware adaptation.

``long_500k`` runs with the attention layers switched to a 4096-token
sliding window (``config(long_context=True)``) — the SSM layers carry
the long-range state.
"""
from ..models.config import LayerSpec, ModelConfig


def _pattern(window: int):
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba2"
        mlp = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, mlp=mlp,
                               window=window if mixer == "attn" else 0))
    return tuple(specs)


def config(long_context: bool = False) -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", d_model=4096, n_layers=32,
        vocab_size=65536,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        n_experts=16, top_k=2, d_ff_expert=14336,
        ssm_state=16, ssm_heads=128, ssm_head_dim=64, ssm_chunk=256,
        pattern=_pattern(4096 if long_context else 0))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", d_model=64, n_layers=8, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        n_experts=4, top_k=2, d_ff_expert=128, router_group=64,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
        pattern=_pattern(0))
