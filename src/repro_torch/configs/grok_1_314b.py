"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1].
"""
from ..models.config import LayerSpec, ModelConfig

_MOE = (LayerSpec(mixer="attn", mlp="moe"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", d_model=6144, n_layers=64, vocab_size=131072,
        n_heads=48, n_kv_heads=8, head_dim=128,
        n_experts=8, top_k=2, d_ff_expert=32768,
        pattern=_MOE, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=4, top_k=2, d_ff_expert=128, router_group=64,
        pattern=_MOE)
