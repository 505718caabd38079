"""Hand-written Hopper kernels (K1-K3) with their plain PyTorch versions."""
