"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

InternViT + InternLM2 [arXiv:2404.16821].  The ViT frontend is a STUB
per the brief: ``input_specs()`` provides 256 precomputed patch
embeddings per image, prepended to the text sequence.  Vocab padded
92553 -> 92560 (model-axis tiling).
"""
from ..models.config import LayerSpec, ModelConfig

_DENSE = (LayerSpec(mixer="attn", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", d_model=2048, n_layers=24, vocab_size=92560,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192,
        n_frontend_tokens=256, pattern=_DENSE, rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
        n_frontend_tokens=8, pattern=_DENSE)
