"""Mamba2 SSD chunked scan — the Hopper kernel, its plain PyTorch
version, and the wrapper that chooses between them.

Replaces ``repro.kernels.ssd_scan.ssd_scan_pallas`` (TPU), with its
signature and layout: x ``(B, S, H, P)``, dt ``(B, S, H)``,
a_log/d_skip/dt_bias ``(H,)``, b/c ``(B, S, G, N)`` and the chunk length
-> y ``(B, S, H, P)`` in x's dtype and the final state ``(B, H, P, N)``
in float32.  Head h reads the B/C group ``h // (H // G)``.

The plain version is the model's chunked algorithm,
:func:`repro_torch.models.ssm.ssd_chunked` (the reference's
``ref.ssd_scan_ref`` delegates to its own the same way).  The wrapper
given CPU tensors runs it; given CUDA tensors it launches the kernel from
``csrc/ssd_scan.cu`` (built at first use) or raises.  There is no fallback
from the card to the plain version.  With grad mode on and an input that
requires a gradient, the kernel's outputs carry the plain version's
gradient (:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`).
Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad

# Launches of the CUDA kernel in this process (the plain version counts
# nothing).
LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_scan_launch": ([_PTR] * 9 + [_INT] * 8 + [_PTR, _PTR], _INT),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SHAPES_PN = ((16, 16), (32, 64), (64, 128))
MAX_CHUNK = 4096


def launch_counts() -> Dict[str, int]:
    return {"ssd_scan": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, dt_bias, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's chunked SSD algorithm (the kernel's oracle)."""
    from repro_torch.models.ssm import ssd_chunked   # models import ops
    return ssd_chunked(x, dt, a_log, b, c, d_skip, dt_bias, chunk)


def _check(x, dt, a_log, b, c, d_skip, dt_bias, chunk) -> None:
    named = (("x", x), ("dt", dt), ("a_log", a_log), ("b", b), ("c", c),
             ("d_skip", d_skip), ("dt_bias", dt_bias))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"x must be (B, S, H, P) and b/c one (B, S, G, N) "
                         f"shape; got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, _ = x.shape
    g = b.shape[2]
    if b.shape[:2] != (bsz, s) or g < 1 or h % g:
        raise ValueError(f"b/c {tuple(b.shape)} do not fit x "
                         f"{tuple(x.shape)} (H must be a multiple of G)")
    if dt.shape != (bsz, s, h):
        raise ValueError(f"dt must be {(bsz, s, h)}, got {tuple(dt.shape)}")
    for name, t in named[2:3] + named[5:]:
        if t.shape != (h,):
            raise ValueError(f"{name} must be ({h},), got {tuple(t.shape)}")
    if not isinstance(chunk, int) or chunk < 1 or s % chunk:
        raise ValueError(f"chunk {chunk!r} must be a positive int dividing "
                         f"the sequence length {s}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share float32 or bfloat16; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    for name, t in (("dt", dt),) + named[2:3] + named[5:]:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan from a zero state.  x (B, S, H, P); dt (B, S, H);
    a_log/d_skip/dt_bias (H,); b, c (B, S, G, N); ``chunk`` divides S.
    x, dt, b and c are read through their strides (the last dim must be
    contiguous).  Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) in float32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream, with the plain
    version's gradient where one is needed."""
    _check(x, dt, a_log, b, c, d_skip, dt_bias, chunk)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, dt_bias, chunk)
    if dev.type != "cuda":
        raise ValueError(f"no ssd_scan for device {dev}")
    return kernel_with_plain_grad(
        lambda *t: _launch(*t, chunk),
        lambda *t: ssd_scan_plain(*t, chunk),
        x, dt, a_log, b, c, d_skip, dt_bias)


def _launch(x, dt, a_log, b, c, d_skip, dt_bias, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = x.device
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (p, n) not in SHAPES_PN or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes (P, N) in {SHAPES_PN} and chunk "
                         f"<= {MAX_CHUNK}; got P={p}, N={n}, chunk={chunk}")
    dt = dt.float()
    a_log, d_skip, dt_bias = (t.float().contiguous()
                              for t in (a_log, d_skip, dt_bias))
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("ssd_scan needs unit-stride last dims of x, b, c")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    if bsz == 0 or s == 0:
        return y, state.zero_()
    strides = (*x.stride()[:3], *dt.stride(), *b.stride()[:3],
               *c.stride()[:3])
    strides_arr = (ctypes.c_longlong * 12)(*strides)
    code = _lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
        state.data_ptr(), bsz, s, h, g, p, n, chunk, _DTYPES[x.dtype],
        ctypes.cast(strides_arr, ctypes.c_void_p),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {code}")
    LAUNCHES += 1
    return y, state
