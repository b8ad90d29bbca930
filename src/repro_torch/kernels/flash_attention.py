"""Flash attention (forward): causal or non-causal GQA attention over a
full sequence — the Hopper kernel, its plain PyTorch version, and the
wrapper that chooses between them.

Replaces ``repro.kernels.flash_attention.flash_attention_flat`` (TPU) and
its wrapper ``repro.kernels.ops.flash_attention``.  Where those transpose
q, k, v to ``(B*H, S, D)`` and pad S to a multiple of 128,
:func:`flash_attention` takes the model's layout as it is — q
``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)`` with ``Hq % Hkv == 0`` — reads
it through its strides, and masks the ragged last tile inside the kernel.

The wrapper given CPU tensors runs :func:`flash_attention_plain`; given
CUDA tensors it launches the kernel from ``csrc/flash_attention.cu``
(built at first use) or raises.  There is no fallback from the card to
the plain version.  With grad mode on and an input that requires a
gradient, the kernel's output carries the plain version's gradient
(:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`; the
backward recomputes the attention in plain float32).  Each launch adds
one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad

NEG_INF = -1e30

# Launches of the CUDA kernel in this process (the plain version counts
# nothing).
LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                                _INT, _INT, _INT, _INT, _PTR,
                                ctypes.c_float, _PTR], _INT),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def launch_counts() -> Dict[str, int]:
    return {"flash_attention": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True
                          ) -> torch.Tensor:
    """What the reference's ``ref.flash_attention_ref`` computes, in the
    model's layout: q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D)
    in q's dtype; scores, softmax and the product with v in float32,
    masked scores at -1e30."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, Hq, D) and k/v one (B, S, Hkv, "
                         f"D) shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    kb, ks, hkv, kd = k.shape
    if (kb, ks, kd) != (b, s, d) or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (Hq must be a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    global LAUNCHES
    dev = q.device
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}; got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a unit-stride head dim")
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    strides_arr = (ctypes.c_longlong * 9)(*strides)
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hkv,
        hq // hkv, d, int(bool(causal)), _DTYPES[q.dtype],
        ctypes.cast(strides_arr, ctypes.c_void_p), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {code}")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention of every position over the sequence (over positions
    <= its own when ``causal``).  q (B, S, Hq, D); k/v (B, S, Hkv, D),
    each read through its strides (the head dim must be contiguous) ->
    (B, S, Hq, D) in q's dtype, contiguous.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream, with
    the plain version's gradient where one is needed."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention for device {dev}")
    return kernel_with_plain_grad(
        lambda q_, k_, v_: _launch(q_, k_, v_, causal),
        lambda q_, k_, v_: flash_attention_plain(q_, k_, v_, causal),
        q, k, v)
