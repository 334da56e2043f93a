"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (used for CPU tensors), plus the torch oracles in ``ref``."""
