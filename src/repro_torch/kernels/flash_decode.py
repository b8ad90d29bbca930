"""Flash decode: one-token GQA attention over a KV cache with a per-row
length — the Hopper kernel, its plain PyTorch version, and the wrapper
that chooses between them.

Replaces ``repro.kernels.flash_decode.flash_decode_flat`` (TPU).  Where
that kernel took a scalar ``kv_len`` and a cache transposed and padded to
``(B*Hkv, S, D)``, :func:`flash_decode` takes the model's layout as it
is — q ``(B, Hq, D)``, caches ``(B, S_max, Hkv, D)`` — and a ``(B,)``
int32 ``kv_len``; a scalar length is the special case of equal rows.

The wrapper given CPU tensors runs :func:`flash_decode_plain`; given
CUDA tensors it launches the kernel from ``csrc/flash_decode.cu`` (built
at first use) or raises.  There is no fallback from the card to the
plain version.  One-token decode has no gradient (the reference does not
differentiate it either): the wrapper raises rather than drop one.  Each
launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_grad

NEG_INF = -1e30

# Launches of the CUDA kernel in this process (the plain version counts
# nothing).
LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_decode_launch": ([_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                             _INT, _INT, _INT, _PTR, ctypes.c_float, _PTR],
                            _INT),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8


def launch_counts() -> Dict[str, int]:
    return {"flash_decode": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_decode", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """The masked softmax of the reference's ``_sdpa`` decode case,
    accumulated in float32: q (B, Hq, D), caches (B, S, Hkv, D), kv_len
    (B,) -> (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float())
    scores = scores / math.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] < \
        kv_len.to(q.device)[:, None]                          # (B, S)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def _check(q, k_cache, v_cache, kv_len) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_len", kv_len)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, Hq, D) and the caches "
                         f"(B, S, Hkv, D); got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    b, hq, d = q.shape
    kb, s, hkv, kd = k_cache.shape
    if kb != b or kd != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len must be ({b},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"q and the caches must share float32 or bfloat16; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor
                 ) -> torch.Tensor:
    """Attention of each row's one query token over the first
    ``kv_len[b]`` positions of its cache rows.  q (B, Hq, D); caches
    (B, S_max, Hkv, D), read through their strides (the head dim must be
    contiguous); kv_len (B,) int32 -> (B, Hq, D) in q's dtype.  CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream.  There is no gradient: with grad mode on and an input
    that requires one, it raises."""
    global LAUNCHES
    _check(q, k_cache, v_cache, kv_len)
    refuse_grad("flash_decode", q, k_cache, v_cache)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_len)
    if dev.type != "cuda":
        raise ValueError(f"no flash_decode for device {dev}")
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if d not in HEAD_DIMS or group > MAX_GROUP:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} and "
                         f"Hq/Hkv <= {MAX_GROUP}; got D={d}, group={group}")
    strides = (q.stride(0), q.stride(1), *k_cache.stride()[:3],
               *v_cache.stride()[:3])
    # the kernel loads two values at a time (8-byte float2 / 4-byte
    # bf16x2), so every row must start at an even element
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or \
            v_cache.stride(3) != 1 or any(x % 2 for x in strides) or \
            any(t.data_ptr() % 8 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode needs a unit-stride head dim, even "
                         "strides and 8-byte-aligned tensors")
    if not kv_len.is_contiguous():
        raise ValueError("kv_len must be contiguous")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    strides_arr = (ctypes.c_longlong * 8)(*strides)
    code = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, hkv, group, s, d,
        _DTYPES[q.dtype], ctypes.cast(strides_arr, ctypes.c_void_p),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {code}")
    LAUNCHES += 1
    return out
