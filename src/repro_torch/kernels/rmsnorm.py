"""RMSNorm and RMSNorm with a fused residual add — kernels for the card,
their plain PyTorch versions, and the wrappers that choose.

Replaces ``repro.kernels.rmsnorm.rms_norm_pallas`` and
``rms_norm_residual_pallas`` (TPU).  Each is one row reduction plus an
elementwise pass with no tensor-core work.  What bounds them on an H100
is bytes (each input read once, each output written once); the fused
form saves the residual stream's extra round trip through device memory
that a separate add would cost.

* ``rms_norm(x, w)``: ``x * rsqrt(mean(x^2) + eps) * w`` in float32,
  stored in x's dtype.  A CUDA kernel (``csrc/rmsnorm.cu``): rows are
  held in registers by teams of lanes sized by the row width
  (:func:`launch_geometry`), read once with 16-byte loads where the
  addresses allow.  At the serve plane's shapes its cost is the host's
  launch path, so that path is one ``torch.empty_like`` and one ctypes
  call with the arguments packed into one array.
* ``rms_norm_residual(x, residual, w)``: ``r = residual + x`` in float32;
  ``new_residual = r`` stored in the input dtype, and the float32 ``r``
  (not its rounded copy) is normalised — as the TPU kernel does.  A
  Triton kernel: one program per row, ``BLOCK = next_pow2(d)`` lanes with
  a mask (``triton`` is imported at its first launch).

The wrappers take ``(..., d)`` tensors with a contiguous last dim.  Given
CPU tensors they run the plain versions; given CUDA tensors they launch
the kernels or raise.  Where grad mode is on and an input requires a
gradient, the kernel's outputs carry the plain version's gradient
(:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`).  Each
launch adds one to :data:`RMS_LAUNCHES` or :data:`RESIDUAL_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad

RMS_LAUNCHES = 0
RESIDUAL_LAUNCHES = 0

MAX_D = 1 << 16

# launch_args' 12 values, the stream, and eps (a double, in the last slot)
_N_ARGS = 14
# no argtypes: the packed array is passed as its pointer with no per-call
# conversion of arguments
_SIGNATURES = {"rms_norm_launch": (None, ctypes.c_int)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# elements in one 16-byte vector
_VEC = {torch.float32: 4, torch.bfloat16: 8}


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
# the CUDA kernel (built at its first launch)
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def launch_geometry(d: int, dtype: torch.dtype,
                    vectorized: bool) -> Tuple[int, int, int, int]:
    """``(vec, vpt, team, threads)`` of ``rms_norm_kernel`` for rows of
    width d: elements a vector (16 bytes' worth where ``vectorized`` and
    the width allow, else 1), vectors a lane holds, lanes a row (a power
    of two), threads a block (``threads // team`` rows a block).  Rows of
    up to 256 vectors take one vector a lane; wider rows take teams of
    256 lanes with up to 8 vectors each, then teams of 1024."""
    vec = _VEC[dtype] if vectorized and d % _VEC[dtype] == 0 else 1
    n_vec = d // vec
    if n_vec <= 256:
        team, vpt = _pow2(n_vec), 1
    else:
        team, vpt = 256, _pow2(-(-n_vec // 256))
        if vpt > 8:
            team, vpt = 1024, _pow2(-(-n_vec // 1024))
    return vec, vpt, team, team if team > 32 else 128


@functools.lru_cache(maxsize=None)
def _rms_fn():
    return _build.load("rmsnorm", _SIGNATURES).rms_norm_launch


# ---------------------------------------------------------------------------
# the Triton kernel (built at its first launch)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """The ``@triton.jit`` residual kernel.  Triton's compile cache goes
    under the checkout's ``build/`` unless ``TRITON_CACHE_DIR`` names one.
    ``triton`` and ``tl`` are bound as module globals, where Triton's
    compiler looks the kernel's names up."""
    global triton, tl
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

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

    return rms_residual_kernel


def build() -> None:
    """Build and load the CUDA library and import Triton now (the Triton
    kernel is compiled at its first launch for the dtype and width it
    sees)."""
    _rms_fn()
    _kernels()


def _launch_shape(d: int) -> Tuple[int, int]:
    """(BLOCK, num_warps) of the Triton kernel for rows of width d."""
    block = _pow2(d)
    return block, max(1, min(16, block // 256))


def _rows(name: str, x: torch.Tensor, d: int) -> torch.Tensor:
    """x (..., d) as a (T, d) view with a contiguous last dim."""
    rows = x.reshape(-1, d)
    if rows.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous last dim")
    return rows


def _check(weight: torch.Tensor, *xs: torch.Tensor) -> int:
    """Validate the inputs of either wrapper; returns the width d.  Kept
    to a few cheap attribute reads: it runs on the serve plane's launch
    path, 57 times a decode step."""
    d = weight.shape[-1]
    if weight.ndim != 1 or not weight.is_contiguous():
        raise ValueError("weight must be a contiguous (d,) tensor")
    dtype = xs[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"rms_norm takes float32 or bfloat16, got {dtype}")
    w_dev = weight.get_device()
    for x in xs:
        # get_device is the CUDA index, -1 off the card: compare devices
        # in full only there
        x_dev = x.get_device()
        if x_dev != w_dev or (x_dev < 0 and x.device != weight.device):
            raise ValueError(f"tensors on {x.device} and {weight.device}")
        if x.dtype != dtype:
            raise TypeError("x and residual must share a dtype")
        if x.ndim < 1 or x.shape[-1] != d:
            raise ValueError(f"rows of width {tuple(x.shape)[-1:]}, weight "
                             f"of width {d}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"row width {d} outside [1, {MAX_D}]")
    return d


@functools.lru_cache(maxsize=None)
def _config(d: int, dtype: torch.dtype, vectorized: bool,
            w_dtype: torch.dtype, w_aligned: bool) -> Tuple[int, ...]:
    """(dtype code, weight kind, vec, vpt, team).  The weight is read as
    x's dtype (kind 0, 16-byte loads when vec > 1) where it has that dtype
    and, for vectors, a 16-byte aligned address; else element by element
    as float32 (1) or bfloat16 (2)."""
    vec, vpt, team, _ = launch_geometry(d, dtype, vectorized)
    if w_dtype == dtype and (vec == 1 or w_aligned):
        kind = 0
    elif w_dtype in _DTYPES:
        kind = 1 if w_dtype == torch.float32 else 2
    else:
        raise TypeError(f"the rms_norm kernel takes a float32 or bfloat16 "
                        f"weight, got {w_dtype}")
    return _DTYPES[dtype], kind, vec, vpt, team


def launch_args(x: torch.Tensor, weight: torch.Tensor,
                out: torch.Tensor) -> Tuple[int, ...]:
    """``rms_norm_launch``'s packed arguments for x (..., d) and ``out``
    of x's shape, contiguous: pointers of x, weight and out, rows, width,
    the row strides of x and out, then :func:`_config`.  x is read in
    16-byte vectors where its base and row stride are 16-byte aligned
    and the width is whole vectors, else element by element."""
    d = weight.shape[0]
    if x.is_contiguous():
        ptr, rows, stride = x.data_ptr(), x.numel() // d, d
    else:
        xr = _rows("x", x, d)
        ptr, rows, stride = xr.data_ptr(), xr.shape[0], xr.stride(0)
    w_ptr = weight.data_ptr()
    vectorized = ptr % 16 == 0 and (
        rows == 1 or stride * x.element_size() % 16 == 0)
    return (ptr, w_ptr, out.data_ptr(), rows, d, stride, d,
            *_config(d, x.dtype, vectorized, weight.dtype, w_ptr % 16 == 0))


_LOCAL = threading.local()


def _caller():
    """This thread's (argument array, a float64 view of its last slot, the
    C function): the array is filled and read within one call, so each
    thread has one."""
    try:
        return _LOCAL.caller
    except AttributeError:
        buf = (ctypes.c_longlong * _N_ARGS)()
        eps = ctypes.c_double.from_buffer(buf, 8 * (_N_ARGS - 1))
        _LOCAL.caller = buf, eps, _rms_fn()
        return _LOCAL.caller


def _rms_norm_launch(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The launch path: one ``torch.empty_like`` and one ctypes call
    (the serve plane makes 57 a decode step, so it is kept short)."""
    global RMS_LAUNCHES
    out = (torch.empty_like(x) if x.is_contiguous() else
           torch.empty_like(x, memory_format=torch.contiguous_format))
    args = launch_args(x, weight, out)
    if not args[3]:
        return out
    buf, eps_slot, fn = _caller()
    dev = x.get_device()
    buf[:-1] = (*args, torch._C._cuda_getCurrentRawStream(dev))
    eps_slot.value = eps
    if dev == torch._C._cuda_getDevice():
        code = fn(buf)
    else:
        with torch.cuda.device(dev):
            code = fn(buf)
    if code != 0:
        raise RuntimeError(f"rms_norm launch failed: cudaError {code}")
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
        kernel = _kernels()
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
    if x.is_cuda:
        if not (torch.is_grad_enabled()          # inline needs_grad: the
                and (x.requires_grad or weight.requires_grad)):  # hot path
            return _rms_norm_launch(x, weight, eps)
        return kernel_with_plain_grad(
            lambda x_, w_: _rms_norm_launch(x_, w_, eps),
            lambda x_, w_: rms_norm_plain(x_, w_, eps), x, weight)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    raise ValueError(f"no rms_norm for device {x.device}")


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
