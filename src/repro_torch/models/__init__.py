from .config import LayerSpec, ModelConfig, param_count
from .transformer import (Transformer, forward, init_model, init_serve_cache,
                          serve_step)

__all__ = ["LayerSpec", "ModelConfig", "param_count", "Transformer",
           "forward", "init_model", "init_serve_cache", "serve_step"]
