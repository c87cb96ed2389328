"""mamba2-130m [ssm]: 24L d=768 attn-free vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060].  d_inner = 2*768 = 1536,
head_dim 64 -> 24 SSD heads.  Vocab padded 50280 -> 50432 (tiling).
"""
from ..models.config import LayerSpec, ModelConfig

_SSM = (LayerSpec(mixer="mamba2", mlp="none"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", d_model=768, n_layers=24, vocab_size=50432,
        ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_chunk=256,
        pattern=_SSM, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", d_model=64, n_layers=2, vocab_size=512,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
        pattern=_SSM, tie_embeddings=True)
