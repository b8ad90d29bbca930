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
  (not its rounded copy) is normalised — as the TPU kernel does.  The
  same CUDA kernel body with the residual added as the row is loaded
  (``rms_norm_residual_kernel``), on the same launch path: one
  allocation holds both outputs.

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
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad
from repro_torch.precision import compute

RMS_LAUNCHES = 0
RESIDUAL_LAUNCHES = 0

MAX_D = 1 << 16

# launch_args' 12 values (residual_launch_args' 14), the stream, and eps
# (a double, in the last slot)
_N_ARGS = 14
_N_RESIDUAL_ARGS = 16
# no argtypes: the packed array is passed as its pointer with no per-call
# conversion of arguments
_SIGNATURES = {"rms_norm_launch": (None, ctypes.c_int),
               "rms_norm_residual_launch": (None, ctypes.c_int)}
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
    xf = compute(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * compute(weight)).to(x.dtype)


def rms_norm_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                            weight: torch.Tensor, eps: float = 1e-6
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    r = compute(residual) + compute(x)
    var = r.square().mean(dim=-1, keepdim=True)
    out = (r * torch.rsqrt(var + eps) * compute(weight)).to(x.dtype)
    return out, r.to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels (built at their first launch)
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def launch_geometry(d: int, dtype: torch.dtype,
                    vectorized: bool) -> Tuple[int, int, int, int]:
    """``(vec, vpt, team, threads)`` of ``rms_norm_kernel`` (and of
    ``rms_norm_residual_kernel``) for rows of
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
def _lib() -> ctypes.CDLL:
    return _build.load("rmsnorm", _SIGNATURES)


def build() -> None:
    """Build and load the CUDA library now (it is otherwise built at the
    first launch)."""
    _lib()


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


def _row_view(name: str, x: torch.Tensor, d: int) -> Tuple[int, int, int]:
    """(pointer, rows, row stride) of x (..., d) read as rows."""
    if x.is_contiguous():
        return x.data_ptr(), x.numel() // d, d
    xr = _rows(name, x, d)
    return xr.data_ptr(), xr.shape[0], xr.stride(0)


def _aligned(ptr: int, rows: int, stride: int, esize: int) -> bool:
    """Whether every row starts at a 16-byte aligned address."""
    return ptr % 16 == 0 and (rows == 1 or stride * esize % 16 == 0)


def launch_args(x: torch.Tensor, weight: torch.Tensor,
                out: torch.Tensor) -> Tuple[int, ...]:
    """``rms_norm_launch``'s packed arguments for x (..., d) and ``out``
    of x's shape, contiguous: pointers of x, weight and out, rows, width,
    the row strides of x and out, then :func:`_config`.  x is read in
    16-byte vectors where its base and row stride are 16-byte aligned
    and the width is whole vectors, else element by element."""
    d = weight.shape[0]
    ptr, rows, stride = _row_view("x", x, d)
    w_ptr = weight.data_ptr()
    vectorized = _aligned(ptr, rows, stride, x.element_size())
    return (ptr, w_ptr, out.data_ptr(), rows, d, stride, d,
            *_config(d, x.dtype, vectorized, weight.dtype, w_ptr % 16 == 0))


def _contiguous(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= max(n, 1)
    return tuple(reversed(strides))


def residual_launch_args(x: torch.Tensor, residual: torch.Tensor,
                         weight: torch.Tensor,
                         out: torch.Tensor) -> Tuple[int, ...]:
    """``rms_norm_residual_launch``'s packed arguments for x and residual
    (..., d) and ``out``, a contiguous buffer of twice x's elements whose
    halves take the normed rows and the new residual: pointers of x,
    residual, weight and the two halves, rows, width, the row strides of
    x and residual, then :func:`_config`.  Vectors where both inputs'
    rows are 16-byte aligned (the halves then are: a row of whole
    vectors is a multiple of 16 bytes)."""
    d = weight.shape[0]
    x_ptr, rows, x_stride = _row_view("x", x, d)
    r_ptr, _, r_stride = _row_view("residual", residual, d)
    esize = x.element_size()
    vectorized = (_aligned(x_ptr, rows, x_stride, esize)
                  and _aligned(r_ptr, rows, r_stride, esize))
    w_ptr, o_ptr = weight.data_ptr(), out.data_ptr()
    return (x_ptr, r_ptr, w_ptr, o_ptr, o_ptr + rows * d * esize, rows, d,
            x_stride, r_stride,
            *_config(d, x.dtype, vectorized, weight.dtype, w_ptr % 16 == 0))


_LOCAL = threading.local()


def _callers():
    """This thread's ``{n_args: (argument array, a float64 view of its
    last slot, the C function)}`` for both entry points: an array is
    filled and read within one call, so each thread has its own."""
    try:
        return _LOCAL.callers
    except AttributeError:
        lib = _lib()
        callers = {}
        for n, fn in ((_N_ARGS, lib.rms_norm_launch),
                      (_N_RESIDUAL_ARGS, lib.rms_norm_residual_launch)):
            buf = (ctypes.c_longlong * n)()
            callers[n] = (buf, ctypes.c_double.from_buffer(buf, 8 * (n - 1)),
                          fn)
        _LOCAL.callers = callers
        return callers


def _call(args: Tuple[int, ...], dev: int, eps: float, name: str) -> None:
    """Pack ``args``, the current stream of CUDA device ``dev`` and eps,
    and call the entry point that takes that many arguments."""
    buf, eps_slot, fn = _callers()[len(args) + 2]
    buf[:-1] = (*args, torch._C._cuda_getCurrentRawStream(dev))
    eps_slot.value = eps
    if dev == torch._C._cuda_getDevice():
        code = fn(buf)
    else:
        with torch.cuda.device(dev):
            code = fn(buf)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


def _rms_norm_launch(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The launch path: one ``torch.empty_like`` and one ctypes call
    (the serve plane makes 57 a decode step, so it is kept short)."""
    global RMS_LAUNCHES
    out = (torch.empty_like(x) if x.is_contiguous() else
           torch.empty_like(x, memory_format=torch.contiguous_format))
    args = launch_args(x, weight, out)
    if args[3]:
        _call(args, x.get_device(), eps, "rms_norm")
        RMS_LAUNCHES += 1
    return out


def _rms_norm_residual_launch(x: torch.Tensor, residual: torch.Tensor,
                              weight: torch.Tensor, eps: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch path: one allocation for both outputs, two views of it
    and one ctypes call (56 a decode step)."""
    global RESIDUAL_LAUNCHES
    n = x.numel()
    buf = x.new_empty(2 * n)
    # two contiguous views of x's shape (as_strided is the cheapest view
    # to make: one allocation and two views cost less host time than two
    # allocations or a (2, ...) buffer's unbind)
    strides = x.stride() if x.is_contiguous() else _contiguous(x.shape)
    normed = buf.as_strided(x.shape, strides)
    new_res = buf.as_strided(x.shape, strides, n)
    args = residual_launch_args(x, residual, weight, buf)
    if args[5]:
        _call(args, x.get_device(), eps, "rms_norm_residual")
        RESIDUAL_LAUNCHES += 1
    return normed, new_res


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
    if x.is_cuda:
        if not (torch.is_grad_enabled() and (
                x.requires_grad or residual.requires_grad
                or weight.requires_grad)):
            return _rms_norm_residual_launch(x, residual, weight, eps)
        return kernel_with_plain_grad(
            lambda x_, r_, w_: _rms_norm_residual_launch(x_, r_, w_, eps),
            lambda x_, r_, w_: rms_norm_residual_plain(x_, r_, w_, eps),
            x, residual, weight)
    if x.device.type == "cpu":
        return rms_norm_residual_plain(x, residual, weight, eps)
    raise ValueError(f"no rms_norm_residual for device {x.device}")
