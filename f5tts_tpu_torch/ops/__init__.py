"""Kernels and plain PyTorch ops of the port."""
