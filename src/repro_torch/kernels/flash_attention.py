"""Flash attention (forward): causal or non-causal GQA attention over a
full sequence — the Hopper kernels, their plain PyTorch version, and the
wrapper that chooses between them.

Replaces ``repro.kernels.flash_attention.flash_attention_flat`` (TPU) and
its wrapper ``repro.kernels.ops.flash_attention``.  Where those transpose
q, k, v to ``(B*H, S, D)`` and pad S to a multiple of 128,
:func:`flash_attention` takes the model's layout as it is — q
``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)`` with ``Hq % Hkv == 0`` — reads
it through its strides, and masks the ragged last tile inside the kernel.

``csrc/flash_attention.cu`` holds two kernels behind one C entry point,
chosen by dtype (:data:`KERNEL_OF`): bfloat16 runs on the tensor cores
(``wgmma``, K/V tiles copied by TMA into a three-stage ring, 128 query
rows a block, heaviest tiles first), float32 on the CUDA cores in full
float32 (64 rows a block).  Both take every head dim that is a multiple
of 8 from 8 to 128 (:func:`head_dim_ok`; zamba2's 80 among them).  The
bfloat16 kernel reads q in 16-byte copies and k/v through TMA maps, so it
needs q, k and v at 16-byte aligned addresses with strides that are
nonzero multiples of 8 elements (those of length-1 dims aside); the
wrapper gives it a fresh contiguous copy of an operand that is not laid
out so (the same kernel runs on the copy) and counts those copies in
:data:`ALIGN_COPIES`.

The wrapper given CPU tensors runs :func:`flash_attention_plain`; given
CUDA tensors it launches the kernel (the library is built at first use)
or raises.  There is no fallback from the card to the plain version.
With grad mode on and an input that requires a gradient, the kernel's
output carries the plain version's gradient
(:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`; the
backward recomputes the attention in plain float32).  Each launch of
either kernel adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta
from repro_torch.kernels.autograd import kernel_with_plain_grad
from repro_torch.precision import compute

NEG_INF = -1e30

# Launches of the CUDA kernel in this process (the plain version counts
# nothing), and operands the bfloat16 path copied to a layout its kernel
# reads.
LAUNCHES = 0
ALIGN_COPIES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_launch": ([_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                                _INT, _INT, _INT, _INT, _PTR,
                                ctypes.c_float, _PTR], _INT),
    "flash_attention_tile_check": ([_PTR, _PTR, _PTR, _PTR, _PTR, _INT,
                                    _PTR], _INT),
}
# the C entry point's dtype code, and the kernel it launches for it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_OF = {torch.float32: "flash_attention_kernel_f32",
             torch.bfloat16: "flash_attention_kernel_bf16"}
ROWS_PER_BLOCK = {torch.float32: 64, torch.bfloat16: 128}
MAX_HEAD_DIM = 128
HEAD_DIM_RULE = f"a multiple of 8 from 8 to {MAX_HEAD_DIM}"


def head_dim_ok(d: int) -> bool:
    """Whether the kernels take head dim ``d`` (:data:`HEAD_DIM_RULE`)."""
    return d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM


def launch_counts() -> Dict[str, int]:
    return {"flash_attention": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES, ALIGN_COPIES
    LAUNCHES = 0
    ALIGN_COPIES = 0


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
    qg = compute(q).reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg,
                          compute(k)) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, compute(v))
    return out.reshape(b, s, hq, d).to(q.dtype)


def launch_geometry(b: int, s: int, hkv: int, group: int,
                    dtype: torch.dtype) -> Tuple[int, int, int]:
    """The grid the kernel for ``dtype`` is launched on.  float32: one
    block per (tile of 64 flattened query rows, kv head, batch row), as
    ``(x, y, z)``; bfloat16: the same blocks for tiles of 128 rows,
    numbered along x alone in the order :func:`block_tile` gives."""
    n_qt = -(-s * group // ROWS_PER_BLOCK[dtype])
    if dtype == torch.float32:
        return n_qt, hkv, b
    return n_qt * hkv * b, 1, 1


def block_tile(block: int, b: int, s: int, hkv: int,
               group: int) -> Tuple[int, int, int]:
    """(query tile, kv head, batch row) of block ``block`` of the
    bfloat16 kernel: all heads' last query tiles first, so the causal
    tiles with the most keys start in the first wave (as in the kernel's
    prologue)."""
    n_qt = -(-s * group // ROWS_PER_BLOCK[torch.bfloat16])
    hb = hkv * b
    return n_qt - 1 - block // hb, block % hb % hkv, block % hb // hkv


def tma_layout_ok(t: torch.Tensor) -> bool:
    """Whether the bfloat16 kernel's 16-byte copies and TMA maps read
    ``t`` as it is: its base address 16-byte aligned, every stride of a
    dim longer than 1 a nonzero multiple of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 and st for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy where :func:`tma_layout_ok`
    fails (counted in :data:`ALIGN_COPIES`)."""
    global ALIGN_COPIES
    if tma_layout_ok(t):
        return t
    ALIGN_COPIES += 1
    return t.clone(memory_format=torch.contiguous_format)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    if not head_dim_ok(d):
        raise ValueError(f"the kernel takes a head_dim that is "
                         f"{HEAD_DIM_RULE}; got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs a unit-stride head dim")
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev)
    if b == 0 or s == 0:
        return out
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    strides_arr = (ctypes.c_longlong * 9)(*strides)
    code = _build.call_on(
        dev.index, _lib().flash_attention_launch, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, s, hkv, hq // hkv, d,
        int(bool(causal)), _DTYPES[q.dtype],
        ctypes.cast(strides_arr, ctypes.c_void_p), 1.0 / math.sqrt(d),
        _stream(dev))
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {code}")
    LAUNCHES += 1
    return out


def _meta_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """The dry-run's launch on ``meta`` tensors (:mod:`.meta`)."""
    b, s, hq, d = q.shape
    return meta.launch("flash_attention", (q, k, v),
                       meta.empty((b, s, hq, d), q.dtype),
                       meta.attention_flops(b, s, hq, d, causal))


def tile_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of the bfloat16 kernel's tensor-core steps alone: q
    (128, D), k and v (64, D), contiguous bfloat16 on the card ->
    ``(q k^T, bf16(q k^T) v)`` in float32, for checking the ``wgmma``
    operand layouts against a plain product (``kernels/selfcheck.py``).
    Counts no launch."""
    d = q.shape[-1]
    if (q.shape != (128, d) or k.shape != (64, d) or v.shape != (64, d)
            or not head_dim_ok(d)):
        raise ValueError(f"tile_check takes q (128, D), k and v (64, D) "
                         f"with D {HEAD_DIM_RULE}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device.type != "cuda":
            raise ValueError("tile_check takes contiguous bfloat16 CUDA "
                             "tensors")
    s_out = torch.empty((128, 64), dtype=torch.float32, device=q.device)
    o_out = torch.empty((128, d), dtype=torch.float32, device=q.device)
    code = _build.call_on(
        q.device.index, _lib().flash_attention_tile_check, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), s_out.data_ptr(), o_out.data_ptr(), d,
        _stream(q.device))
    if code != 0:
        raise RuntimeError(f"flash_attention tile check failed: cudaError "
                           f"{code}")
    return s_out, o_out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention of every position over the sequence (over positions
    <= its own when ``causal``).  q (B, S, Hq, D); k/v (B, S, Hkv, D),
    each read through its strides (the head dim must be contiguous) ->
    (B, S, Hq, D) in q's dtype, contiguous.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream, with
    the plain version's gradient where one is needed; ``meta`` tensors
    take the dry-run's meta launch (:mod:`.meta`), with the same
    gradient."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if dev.type == "meta":
        return kernel_with_plain_grad(
            lambda q_, k_, v_: _meta_launch(q_, k_, v_, causal),
            lambda q_, k_, v_: flash_attention_plain(q_, k_, v_, causal),
            q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention for device {dev}")
    return kernel_with_plain_grad(
        lambda q_, k_, v_: _launch(q_, k_, v_, causal),
        lambda q_, k_, v_: flash_attention_plain(q_, k_, v_, causal),
        q, k, v)
