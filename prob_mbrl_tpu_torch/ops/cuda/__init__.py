"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``)."""
