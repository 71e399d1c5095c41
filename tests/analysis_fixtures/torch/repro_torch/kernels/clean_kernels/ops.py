"""Clean counterpart for the port's kernel pass: zero findings.

Read as the ``ops.py`` of the kernel package ``clean_kernels``: each entry
takes the plain version (``clean_kernels.ref``) on CPU tensors only,
launches or raises on the card, and is named by both on-card files beside
the corpus.
"""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clean_kernels import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)

try:  # an optional import, not a kernel build: any handler will do
    import triton
except ImportError:
    triton = None


def _kernel():
    try:
        return _build.load("flash_decode")
    except OSError as e:
        raise RuntimeError("flash_decode: no kernel library") from e


def flash_attention(q, k, v):
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v)
    return flash_attention_cuda(q, k, v, causal=True, q_offset=0)


def flash_decode(q, k, v, *, kv_len):
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len=kv_len)
    return _kernel().repro_flash_decode(q, k, v, kv_len)


def reload(_build, name):
    """Not a kernel entry: ``_build`` is this function's parameter (any
    object with a ``load``), not the module's kernel builder."""
    return _build.load(name)


def resolve_device(device):
    if device == "cpu":  # the caller asked for the CPU
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain versions")
    return torch.device("cuda")
