"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

llama-arch small [hf:HuggingFaceTB/SmolLM-135M].
"""
from ..models.config import LayerSpec, ModelConfig

_DENSE = (LayerSpec(mixer="attn", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", d_model=576, n_layers=30, vocab_size=49152,
        n_heads=9, n_kv_heads=3, head_dim=64, d_ff=1536,
        pattern=_DENSE, tie_embeddings=True, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        pattern=_DENSE, tie_embeddings=True)
