from .config import LayerSpec, ModelConfig, param_count
from .transformer import (Transformer, for_serving, forward, init_model,
                          init_serve_cache, loss_fn, serve_step)

__all__ = ["LayerSpec", "ModelConfig", "param_count", "Transformer",
           "for_serving", "forward", "init_model", "init_serve_cache",
           "loss_fn", "serve_step"]
