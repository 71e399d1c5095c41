"""Known-bad corpus for the port's kernel pass (parsed, never run).

Read as the ``ops.py`` of the kernel package ``bad_kernels``: its public
functions that reach a kernel build are kernel entries, its plain versions
are the functions of ``bad_kernels.ref``, and the files that name entries
on the card are ``on_card_chip_smoke.py`` and
``on_card_test_torch_cuda.py`` beside the corpus.
"""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bad_kernels import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda,
)


def _kernel():
    return _build.load("flash_decode")


def flash_attention(q, k, v):
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v)
    try:
        return flash_attention_cuda(q, k, v, causal=True, q_offset=0)
    except RuntimeError:  # expect: kernel-silent-fallback
        return ref.attention_ref(q, k, v)


def flash_decode(q, k, v, *, kv_len):
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len=kv_len)
    try:
        lib = _kernel()
    except OSError:  # expect: kernel-silent-fallback
        lib = None
    return lib.repro_flash_decode(q, k, v, kv_len)


def flash_decode_partials(q, k, v, *, kv_len):
    try:
        lib = _kernel()
    except OSError as e:  # expect: kernel-silent-fallback
        ref.flash_decode_partials_ref(q, k, v, kv_len=kv_len)
        raise RuntimeError("no kernel library") from e
    return lib.repro_flash_decode_partials(q, k, v, kv_len)


def flash_decode_int8(q, kq, ks, vq, vs, *, kv_len):  # expect: kernel-no-plain
    return _kernel().repro_flash_decode_int8(q, kq, ks, vq, vs, kv_len)


# named by on_card_chip_smoke.py; by on_card_test_torch_cuda.py only through
# a parameter and a local that bear the name of an import in another function
def flash_decode_unchecked(q, k, v, *, kv_len):  # expect: kernel-not-on-card
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len=kv_len)
    return _kernel().repro_flash_decode(q, k, v, kv_len)


# named by on_card_test_torch_cuda.py; by on_card_chip_smoke.py only through
# a parameter that hides the module's import of the same name
def flash_decode_shadowed(q, k, v, *, kv_len):  # expect: kernel-not-on-card
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len=kv_len)
    return _kernel().repro_flash_decode(q, k, v, kv_len)


def pick_device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")  # expect: device-cpu-fallback


def pick_device_branch():
    if not torch.cuda.is_available():  # expect: device-cpu-fallback
        return "cpu"
    return "cuda"
