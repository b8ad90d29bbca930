"""Block-scaled int8 quantize and dequantize — the Hopper kernels, their
plain PyTorch versions, and the wrappers that choose between them.

Replaces ``repro.kernels.quantize.quantize_pallas`` and
``dequantize_pallas`` (TPU), with their arithmetic: each block of
``block`` elements of a flat ``(n,)`` tensor gets the float32 scale
``max(absmax, 1e-12) / 127`` and the int8 values
``clip(round(x / scale), -127, 127)``; dequantize multiplies back.  With
``block`` equal to one worker's shard this is exactly the reference's
in-graph ``repro.core.gradsync._quantize_int8`` (one scale per shard),
which is how :func:`repro_torch.core.gradsync.compressed_psum_mean`
calls it.

The wrappers given CPU tensors run the plain versions; given CUDA tensors
they launch the kernels from ``csrc/quantize.cu`` (built at first use) or
raise.  There is no fallback from the card to the plain version.  The
kernels and the plain versions agree bit for bit (IEEE division, round
half to even).  Each launch adds one to :data:`QUANTIZE_LAUNCHES` or
:data:`DEQUANTIZE_LAUNCHES`.  Neither has a gradient: the reduction they
serve runs on gradients, outside autograd.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# Launches of the CUDA kernels in this process (the plain versions count
# nothing).
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "quantize_launch": ([_PTR, _PTR, _PTR, _PTR, _LL, _LL, _INT, _PTR],
                        _INT),
    "dequantize_launch": ([_PTR, _PTR, _PTR, _LL, _LL, _INT, _PTR], _INT),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 256 * 16              # elements per CTA (csrc/quantize.cu)
MAX_GRID = (1 << 31) - 1


def launch_counts() -> Dict[str, int]:
    return {"quantize": QUANTIZE_LAUNCHES, "dequantize": DEQUANTIZE_LAUNCHES}


def reset_launch_counts() -> None:
    global QUANTIZE_LAUNCHES, DEQUANTIZE_LAUNCHES
    QUANTIZE_LAUNCHES = 0
    DEQUANTIZE_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    return _build.load("quantize", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def quantize_plain(x: torch.Tensor, block: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n,) -> (q (n,) int8, scales (n / block,) float32)."""
    xb = x.float().reshape(-1, block)
    absmax = torch.clamp(xb.abs().amax(dim=1), min=1e-12)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ by one ulp
    scales = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xb / scales[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scales


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, block: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse: ``(float)q * scale`` of its block, in ``out_dtype``."""
    x = q.reshape(-1, block).float() * scales[:, None]
    return x.reshape(-1).to(out_dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_block(n: int, block: int) -> None:
    if not isinstance(block, int) or block < 1 or n % block:
        raise ValueError(f"block {block!r} must be a positive int dividing "
                         f"the length {n}")
    if n and (n // block) * -(-block // TILE) > MAX_GRID:
        raise ValueError(f"{n // block} blocks of {block} exceed the "
                         "kernel's grid")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def quantize(x: torch.Tensor, block: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n,) float32 or bfloat16, ``block`` dividing n -> (q (n,) int8,
    scales (n / block,) float32).  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream."""
    global QUANTIZE_LAUNCHES
    if x.dim() != 1:
        raise ValueError(f"quantize takes a flat (n,) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize takes float32 or bfloat16, got {x.dtype}")
    n = x.shape[0]
    _check_block(n, block)
    dev = x.device
    if dev.type == "cpu":
        return quantize_plain(x, block)
    if dev.type != "cuda":
        raise ValueError(f"no quantize for device {dev}")
    x = x.contiguous()
    q = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(n // block, dtype=torch.float32, device=dev)
    scratch = torch.empty(n // block if block > TILE else 1,
                          dtype=torch.int32, device=dev)
    code = _lib().quantize_launch(x.data_ptr(), q.data_ptr(),
                                  scales.data_ptr(), scratch.data_ptr(), n,
                                  block, _DTYPES[x.dtype], _stream(dev))
    if code != 0:
        raise RuntimeError(f"quantize launch failed: cudaError {code}")
    QUANTIZE_LAUNCHES += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (n,) int8, scales (n / block,) float32 -> (n,) ``out_dtype``
    (float32 or bfloat16).  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream."""
    global DEQUANTIZE_LAUNCHES
    if q.dim() != 1 or q.dtype != torch.int8:
        raise TypeError(f"dequantize takes a flat int8 q, got {q.dtype} "
                        f"{tuple(q.shape)}")
    n = q.shape[0]
    _check_block(n, block)
    if scales.shape != (n // block,) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32 ({n // block},), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"dequantize writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if scales.device != q.device:
        raise ValueError(f"scales on {scales.device}, q on {q.device}")
    dev = q.device
    if dev.type == "cpu":
        return dequantize_plain(q, scales, block, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no dequantize for device {dev}")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty(n, dtype=out_dtype, device=dev)
    code = _lib().dequantize_launch(q.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), n, block,
                                    _DTYPES[out_dtype], _stream(dev))
    if code != 0:
        raise RuntimeError(f"dequantize launch failed: cudaError {code}")
    DEQUANTIZE_LAUNCHES += 1
    return out
