from .config import LayerSpec, ModelConfig, param_count
from .mla import MLA, apply_mla, init_mla, init_mla_cache
from .moe import MoE, apply_moe, init_moe
from .ssm import Mamba2, apply_mamba2, init_mamba2, init_mamba2_cache
from .transformer import (Encoder, Transformer, encode, for_serving,
                          forward, init_model, init_serve_cache, loss_fn,
                          serve_step)

__all__ = ["LayerSpec", "ModelConfig", "param_count", "MLA", "apply_mla",
           "init_mla", "init_mla_cache", "MoE", "apply_moe", "init_moe",
           "Mamba2", "apply_mamba2", "init_mamba2", "init_mamba2_cache",
           "Encoder", "Transformer", "encode", "for_serving", "forward",
           "init_model", "init_serve_cache", "loss_fn", "serve_step"]
