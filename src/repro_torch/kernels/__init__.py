"""TACO operators: plain PyTorch versions and hand-written CUDA kernels."""
