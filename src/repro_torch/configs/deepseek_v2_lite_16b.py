"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff_expert=1408
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed experts top-6
[arXiv:2405.04434].

Layer 0 is a dense-MLP MLA layer (prologue); layers 1..26 are MLA+MoE.
MLA dims: qk_nope=128, qk_rope=64, v_head=128; dense d_ff=10944.
"""
from ..models.config import LayerSpec, ModelConfig

_MOE = (LayerSpec(mixer="mla", mlp="moe"),)
_PRO = (LayerSpec(mixer="mla", mlp="dense"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", d_model=2048, n_layers=27,
        vocab_size=102400, n_heads=16, head_dim=192, d_ff=10944,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
        pattern=_MOE, prologue=_PRO, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", d_model=64, n_layers=3, vocab_size=512,
        n_heads=4, head_dim=24, d_ff=160,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, n_shared_experts=1, top_k=2, d_ff_expert=64,
        router_group=64, pattern=_MOE, prologue=_PRO)
