"""qwen3-4b [dense]: 36L d=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm, GQA [hf:Qwen/Qwen3].
"""
from ..models.config import LayerSpec, ModelConfig

_DENSE = (LayerSpec(mixer="attn", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", d_model=2560, n_layers=36, vocab_size=151936,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
        qk_norm=True, pattern=_DENSE, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160, qk_norm=True,
        pattern=_DENSE)
