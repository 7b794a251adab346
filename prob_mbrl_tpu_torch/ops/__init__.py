"""Numerics: Cholesky, angle embedding, moment matching, CUDA kernels."""
