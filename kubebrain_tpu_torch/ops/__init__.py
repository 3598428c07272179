"""Scan operators: the plain PyTorch visibility scan (``scan``) and the
wrappers of its CUDA kernels (``scan_kernels``)."""
