"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

llama-arch GQA [arXiv:2403.04652].
"""
from ..models.config import LayerSpec, ModelConfig

_DENSE = (LayerSpec(mixer="attn", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", d_model=4096, n_layers=32, vocab_size=64000,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008,
        pattern=_DENSE, rope_theta=5_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160, pattern=_DENSE)
