"""Hand-written kernels (CUDA C++ under ``csrc/``) with their plain versions."""
