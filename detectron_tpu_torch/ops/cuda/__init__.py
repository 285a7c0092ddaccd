"""Wrappers of the port's hand-written CUDA kernels (sources in csrc/).

Each wrapper module holds the kernel's wrapper and, beside it, a plain
PyTorch version of the same function. The wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel (on
the current stream) or raises. Each wrapper counts its launches in a plain
integer attribute, `<wrapper>.launches`.
"""
