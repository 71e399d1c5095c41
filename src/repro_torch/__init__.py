"""PyTorch/CUDA port of the Hercules reproduction.

Mirrors the subpackage and module names of the JAX package ``repro`` so
each counterpart is easy to find, but imports neither ``jax`` nor anything
of ``repro``: the numpy scheduler and simulator are carried as copies.

Entry points run on the GPU (``device="cuda"``) and raise when no card is
present; a caller asks for the CPU explicitly with ``device="cpu"``, which
routes every kernel wrapper to its plain PyTorch version.
"""
