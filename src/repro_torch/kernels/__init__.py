"""Hand-written CUDA kernels, their plain PyTorch versions and the dispatch layer."""
