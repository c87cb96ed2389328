"""Kernels of the port: hand-written CUDA for Hopper, each with its
plain PyTorch version (``ref.py``) and a launch wrapper."""
