"""Kernels of the port: each module holds a CUDA kernel's wrapper, its
plain PyTorch version and the host constants it needs."""
