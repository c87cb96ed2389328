"""whisper-medium [audio]: enc-dec, 24L enc + 24L dec, d=1024 16H
(MHA kv=16) d_ff=4096 vocab=51865 [arXiv:2212.04356].

The conv frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, frames, d).  LayerNorm + GELU MLP + absolute
sinusoidal positions (no RoPE), faithful to whisper.  Vocab padded
51865 -> 51872.

Shape interpretation for enc-dec (documented in DESIGN.md): the
brief's ``seq_len`` drives the *audio* axis (the long axis for speech):
train/prefill run ``seq_len`` encoder frames with a 448-token decoder;
decode cells attend over a ``seq_len`` cross-attention cache with the
standard 448-position decoder self-cache.
"""
from ..models.config import LayerSpec, ModelConfig

_DEC = (LayerSpec(mixer="attn", mlp="dense", cross=True),)

DECODER_LEN = 448


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", d_model=1024, n_layers=24,
        vocab_size=51872,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
        pattern=_DEC, is_encoder_decoder=True, n_encoder_layers=24,
        encoder_frames=1500, mlp_gelu=True, use_layernorm=True,
        use_rope=False, max_seq_len=65536)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", d_model=64, n_layers=2, vocab_size=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        pattern=_DEC, is_encoder_decoder=True, n_encoder_layers=2,
        encoder_frames=32, mlp_gelu=True, use_layernorm=True,
        use_rope=False, max_seq_len=4096)
