"""PyTorch/CUDA port of prob_mbrl_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout and names; the JAX package is the reference
it is tested against. Entry points run on ``cuda`` unless the caller passes
``device='cpu'``.
"""
