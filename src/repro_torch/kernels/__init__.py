"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a, built
on first use) with their plain PyTorch versions."""
