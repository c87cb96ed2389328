"""SMURFF's Gibbs sampler in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` to PyTorch on an NVIDIA H100.  It
mirrors ``repro``'s module paths (``repro_torch/core/gibbs.py`` is the
counterpart of ``repro/core/gibbs.py``) and never imports JAX or
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor the kernel wrappers of ``kernels/``
launch the hand-written kernels, on a CPU tensor they run the plain
PyTorch versions.
"""
import torch

# every float32 product in the port is full float32, never TF32, and
# every bf16 product accumulates in float32 to the end: cuBLAS may not
# reduce split-K partial sums in bf16
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
