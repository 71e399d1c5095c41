"""Kernels written by hand for Hopper (sm_90a), one per TPU kernel of the
reference that the port has reached.

- embedding_bag (K1): fused SparseLengthsSum over a hot table, CUDA C++.

Each kernel ships ``csrc/*.cu`` (the kernel, plain C interface),
``<name>.py`` (the ctypes launcher), ``ops.py`` (the wrapper: plain version
for CPU tensors, the kernel for CUDA tensors, a launch count) and
``ref.py`` (the plain PyTorch version).  ``_build`` compiles the sources
with nvcc at first use.  The reference's DLRM ``dot_interaction`` has no
kernel in either package; the port computes it with torch ops.
"""
