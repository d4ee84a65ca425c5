"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built by ``build.py``), each beside its plain PyTorch version."""
