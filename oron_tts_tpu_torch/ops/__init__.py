"""Kernels and audio ops. Each kernel module holds its CUDA wrapper and plain version."""
