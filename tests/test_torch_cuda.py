"""The redesigned attention kernels on the card, against their plain
versions: K3's int8 entry (within the bf16/f32 tolerance of its plain
version, and bitwise equal to the entry in q's dtype on the cache
dequantised eagerly), K3's bf16 entry at the head sizes its CUDA-core
variant takes, and K2's tensor-core variant at ragged Tq/Tk, with
q_offset, at head sizes 64 and 128.

Imports neither jax nor the reference, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  Without
a card every test skips.  Tolerances are those of tests/test_kernels.py:
f32 2e-4, bf16 3e-2."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    attention_ref,
    flash_attention,
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_ref,
    flash_decode_ref,
)
from repro_torch.kernels.flash_attention.ref import dequantize_kv

TOL = {"f32": 2e-4, "bf16": 3e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _int8_cache(seed, B, S, KVH, hd, device):
    """An int8 cache and f32 scales in [0.005, 0.02] on ``device``."""
    rng = np.random.default_rng(seed)
    kq, vq = (rng.integers(-127, 128, (B, S, KVH, hd), dtype=np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, (B, S, KVH, 1)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(a).to(device) for a in (kq, ks, vq, vs)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kv_len,kv_offset", [(700, 0), (333, 0), (900, 300)])
def test_int8_decode_matches_plain(cuda_device, dtype, kv_len, kv_offset):
    tdt = TDT[dtype]
    B, S, H, KVH, hd = 2, 700, 6, 2, 128
    q = (torch.from_numpy(_normal(3, (B, 1, H, hd))[0]) * 8).to(cuda_device,
                                                               tdt)
    kq, ks, vq, vs = _int8_cache(4, B, S, KVH, hd, cuda_device)
    got = flash_decode_int8(q, kq, ks, vq, vs, kv_len=kv_len,
                            kv_offset=kv_offset)
    want = flash_decode_int8_ref(q, kq, ks, vq, vs, kv_len=kv_len,
                                 kv_offset=kv_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    same = flash_decode(q, dequantize_kv(kq, ks, tdt),
                        dequantize_kv(vq, vs, tdt), kv_len=kv_len,
                        kv_offset=kv_offset)
    assert torch.equal(got, same)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", [8, 16, 32])
def test_bf16_decode_small_heads(cuda_device, hd):
    """bf16 head sizes off the tensor-core variant take the CUDA-core one;
    the int8 entry keeps to the tensor-core sizes."""
    B, S, H, KVH = 2, 700, 6, 2
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _normal(hd, (B, 1, H, hd), (B, S, KVH, hd),
                                (B, S, KVH, hd)))
    got = flash_decode(q, k, v, kv_len=650, kv_offset=0)
    want = flash_decode_ref(q.float(), k.float(), v.float(), kv_len=650)
    torch.testing.assert_close(got.float(), want, rtol=TOL["bf16"],
                               atol=TOL["bf16"])
    kq, ks, vq, vs = _int8_cache(5, B, S, KVH, hd, cuda_device)
    with pytest.raises(ValueError):
        flash_decode_int8(q, kq, ks, vq, vs, kv_len=650)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,q_offset,tq", [(True, 133, 200),
                                                (False, 0, 200),
                                                (True, 0, 129)])
def test_flash_attention_ragged_and_offset(cuda_device, hd, causal, q_offset,
                                           tq):
    """Tq and Tk not multiples of the kernel's 128-row tiles."""
    qn, kn, vn = _normal(hd, (2, tq, 6, hd), (2, 333, 2, hd), (2, 333, 2, hd))
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in (qn * 8, kn, vn))
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         q_offset=q_offset)
    torch.testing.assert_close(got.float(), want, rtol=TOL["bf16"],
                               atol=TOL["bf16"])
    torch.cuda.synchronize()
