"""Hand-written Hopper kernels (CUDA C++ sources under ``../csrc``) with
their plain PyTorch versions and launch counters."""
