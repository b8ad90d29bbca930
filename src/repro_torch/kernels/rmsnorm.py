"""RMSNorm and RMSNorm with a fused residual add — Triton kernels for the
card, their plain PyTorch versions, and the wrappers that choose.

Replaces ``repro.kernels.rmsnorm.rms_norm_pallas`` and
``rms_norm_residual_pallas`` (TPU).  Each is one row reduction plus an
elementwise pass with no tensor-core work, which is Triton's block model:
one program per row, ``BLOCK = next_pow2(d)`` lanes with a mask, the sum
of squares reduced in float32.  What bounds them on an H100 is bytes
(each input read once, each output written once); the fused form saves
the residual stream's extra round trip through device memory that a
separate add would cost.

* ``rms_norm(x, w)``: ``x * rsqrt(mean(x^2) + eps) * w`` in float32,
  stored in x's dtype.
* ``rms_norm_residual(x, residual, w)``: ``r = residual + x`` in float32;
  ``new_residual = r`` stored in the input dtype, and the float32 ``r``
  (not its rounded copy) is normalised — as the TPU kernel does.

The wrappers take ``(..., d)`` tensors with a contiguous last dim.  Given
CPU tensors they run the plain versions; given CUDA tensors they launch
the Triton kernels (``triton`` is imported there, at the first launch) or
raise.  Where grad mode is on and an input requires a gradient, the
kernel's outputs carry the plain version's gradient
(:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`).  Each
launch adds one to :data:`RMS_LAUNCHES` or :data:`RESIDUAL_LAUNCHES`.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad

RMS_LAUNCHES = 0
RESIDUAL_LAUNCHES = 0

MAX_D = 1 << 16


def launch_counts() -> Dict[str, int]:
    return {"rms_norm": RMS_LAUNCHES, "rms_norm_residual": RESIDUAL_LAUNCHES}


def reset_launch_counts() -> None:
    global RMS_LAUNCHES, RESIDUAL_LAUNCHES
    RMS_LAUNCHES = 0
    RESIDUAL_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                            weight: torch.Tensor, eps: float = 1e-6
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    r = residual.float() + x.float()
    var = r.square().mean(dim=-1, keepdim=True)
    out = (r * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
    return out, r.to(x.dtype)


# ---------------------------------------------------------------------------
# Triton kernels (built at the first CUDA launch)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """The two ``@triton.jit`` kernels.  Triton's compile cache goes under
    the checkout's ``build/`` unless ``TRITON_CACHE_DIR`` names one.
    ``triton`` and ``tl`` are bound as module globals, where Triton's
    compiler looks the kernels' names up."""
    global triton, tl
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rms_kernel(x_ptr, w_ptr, o_ptr, stride_x, stride_o, d, eps,
                   BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * (1.0 / tl.sqrt(var + eps)) * w
        tl.store(o_ptr + row * stride_o + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def rms_residual_kernel(x_ptr, r_ptr, w_ptr, o_ptr, nr_ptr, stride_x,
                            stride_r, stride_o, stride_nr, d, eps,
                            BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        res = tl.load(r_ptr + row * stride_r + cols, mask=mask,
                      other=0.0).to(tl.float32)
        r = res + x
        tl.store(nr_ptr + row * stride_nr + cols,
                 r.to(nr_ptr.dtype.element_ty), mask=mask)
        var = tl.sum(r * r, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = r * (1.0 / tl.sqrt(var + eps)) * w
        tl.store(o_ptr + row * stride_o + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return rms_kernel, rms_residual_kernel


def build() -> None:
    """Import Triton and define the kernels now (each is compiled at its
    first launch for the dtype and width it sees)."""
    _kernels()


def _launch_shape(d: int) -> Tuple[int, int]:
    """(BLOCK, num_warps) for rows of width d."""
    block = 1 << max(d - 1, 0).bit_length()
    return block, max(1, min(16, block // 256))


def _rows(name: str, x: torch.Tensor, d: int) -> torch.Tensor:
    """x (..., d) as a (T, d) view with a contiguous last dim."""
    rows = x.reshape(-1, d)
    if rows.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")
    return rows


def _check(weight: torch.Tensor, *xs: torch.Tensor) -> int:
    d = weight.shape[-1]
    if weight.dim() != 1 or not weight.is_contiguous():
        raise ValueError("weight must be a contiguous (d,) tensor")
    for x in xs:
        if x.device != weight.device:
            raise ValueError(f"tensors on {x.device} and {weight.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"rms_norm takes float32 or bfloat16, got "
                            f"{x.dtype}")
        if x.dtype != xs[0].dtype:
            raise TypeError("x and residual must share a dtype")
        if x.dim() < 1 or x.shape[-1] != d:
            raise ValueError(f"rows of width {tuple(x.shape)[-1:]}, weight "
                             f"of width {d}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"row width {d} outside [1, {MAX_D}]")
    return d


def _rms_norm_launch(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    global RMS_LAUNCHES
    d = weight.shape[-1]
    xr = _rows("x", x, d)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    orows = out.view(-1, d)
    if xr.shape[0]:
        kernel, _ = _kernels()
        block, warps = _launch_shape(d)
        with torch.cuda.device(x.device):
            kernel[(xr.shape[0],)](xr, weight, orows, xr.stride(0),
                                   orows.stride(0), d, eps, BLOCK=block,
                                   num_warps=warps)
        RMS_LAUNCHES += 1
    return out


def _rms_norm_residual_launch(x: torch.Tensor, residual: torch.Tensor,
                              weight: torch.Tensor, eps: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    global RESIDUAL_LAUNCHES
    d = weight.shape[-1]
    xr, rr = _rows("x", x, d), _rows("residual", residual, d)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    new_res = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    orows, nrows = out.view(-1, d), new_res.view(-1, d)
    if xr.shape[0]:
        _, kernel = _kernels()
        block, warps = _launch_shape(d)
        with torch.cuda.device(x.device):
            kernel[(xr.shape[0],)](xr, rr, weight, orows, nrows,
                                   xr.stride(0), rr.stride(0),
                                   orows.stride(0), nrows.stride(0), d, eps,
                                   BLOCK=block, num_warps=warps)
        RESIDUAL_LAUNCHES += 1
    return out, new_res


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), weight (d,) -> same shape and dtype as x.  On CUDA
    tensors that need a gradient, the kernel's output carries the plain
    version's gradient (:mod:`repro_torch.kernels.autograd`)."""
    _check(weight, x)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rms_norm for device {x.device}")
    return kernel_with_plain_grad(
        lambda x_, w_: _rms_norm_launch(x_, w_, eps),
        lambda x_, w_: rms_norm_plain(x_, w_, eps), x, weight)


def rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(residual + x) -> rmsnorm``.  x, residual (..., d) of one
    shape and dtype, weight (d,) -> ``(normed, new_residual)``, with the
    plain version's gradient where one is needed, as :func:`rms_norm`."""
    _check(weight, x, residual)
    if x.shape != residual.shape:
        raise ValueError(f"x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} differ")
    if x.device.type == "cpu":
        return rms_norm_residual_plain(x, residual, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rms_norm_residual for device {x.device}")
    return kernel_with_plain_grad(
        lambda x_, r_, w_: _rms_norm_residual_launch(x_, r_, w_, eps),
        lambda x_, r_, w_: rms_norm_residual_plain(x_, r_, w_, eps),
        x, residual, weight)
