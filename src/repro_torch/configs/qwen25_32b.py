"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  GQA, QKV bias [hf:Qwen/Qwen2.5].
"""
from ..models.config import LayerSpec, ModelConfig

_DENSE = (LayerSpec(mixer="attn", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", d_model=5120, n_layers=64, vocab_size=152064,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648,
        qkv_bias=True, pattern=_DENSE, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen25-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, qkv_bias=True,
        pattern=_DENSE)
