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
half to even).  A quantize call whose block is larger than one tile runs
two passes over a persistent grid that :func:`launch_geometry` lays out,
in one cooperative launch (no atomics, no zeroed scratch).  Each
wrapper call that launches adds one to :data:`QUANTIZE_LAUNCHES` or
:data:`DEQUANTIZE_LAUNCHES`.  Neither has a gradient: the reduction they
serve runs on gradients, outside autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.kernels import _build

# Launches of the CUDA kernels in this process (the plain versions count
# nothing).
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "quantize_launch": ([_PTR, _PTR, _PTR, _PTR, _LL, _LL, _LL, _LL, _INT,
                         _INT, _PTR], _INT),
    "quantize_max_grid": ([_INT, _INT, ctypes.POINTER(_INT)], _INT),
    "dequantize_launch": ([_PTR, _PTR, _PTR, _LL, _LL, _INT, _PTR], _INT),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                # threads of a CTA (csrc/quantize.cu)
GROUP = 16                   # elements a thread takes from a tile
TILE = THREADS * GROUP       # elements a CTA takes at a time
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

@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one quantize call is cut up (``csrc/quantize.cu``).

    ``fused``: one CTA of THREADS threads per block (``grid`` = n / block
    CTAs), for ``block <= TILE``; thread t takes the groups of ``group``
    elements (aligned to the input) ``t, t + THREADS, ...`` that meet
    the block.  Otherwise ``grid`` persistent CTAs of THREADS threads,
    ``group`` = GROUP; CTA ``c`` owns the elements ``[c * span, min((c +
    1) * span, n))``, in tiles of TILE, and writes the absmax of each
    block ``b`` its span meets to partial slot ``c + b`` (``partials``
    slots in all)."""
    n: int
    block: int
    fused: bool
    grid: int
    group: int = GROUP
    span: int = 0

    @property
    def blocks(self) -> int:
        return self.n // self.block

    @property
    def partials(self) -> int:
        return 1 if self.fused else self.grid + self.blocks - 1

    def span_of(self, c: int) -> Tuple[int, int]:
        """The elements ``[lo, hi)`` CTA ``c`` owns (persistent passes)."""
        lo = c * self.span
        return lo, min(lo + self.span, self.n)

    def tiles(self, c: int, reverse: bool = False
              ) -> Iterator[Tuple[int, int]]:
        """CTA ``c``'s tiles ``[ts, te)`` in the order pass 1 walks them,
        or pass 2 (``reverse``)."""
        lo, hi = self.span_of(c)
        starts = range(lo, hi, TILE)
        for ts in (reversed(starts) if reverse else starts):
            yield ts, min(ts + TILE, hi)

    def blocks_of(self, c: int) -> range:
        """The blocks CTA ``c``'s span meets."""
        lo, hi = self.span_of(c)
        return range(lo // self.block, (hi - 1) // self.block + 1)

    def ctas_of(self, b: int) -> range:
        """The CTAs whose spans meet block ``b``: pass 2 reduces their
        partial slots ``c + b``."""
        return range(b * self.block // self.span,
                     ((b + 1) * self.block - 1) // self.span + 1)

    @staticmethod
    def slot(c: int, b: int) -> int:
        return c + b


def fused_group(block: int) -> int:
    """The elements a fused CTA's thread takes at a time: the largest of
    2, 4, 8, 16 that still leaves every thread a group (at least
    THREADS groups in the block), so a thread divides about block /
    THREADS elements, as a one-element layout would have it do."""
    group = 2
    while group < GROUP and 2 * group * THREADS <= block:
        group *= 2
    return group


def launch_geometry(n: int, block: int, max_grid: int) -> Geometry:
    """The launch of one quantize call of n elements in blocks of
    ``block``, with at most ``max_grid`` resident CTAs (SMs x blocks an
    SM, from the card): a CTA a block for ``block <= TILE``; else the
    fewest persistent CTAs that cover the tiles with the most CTAs
    resident, so every CTA owns at least one tile."""
    if block <= TILE:
        return Geometry(n, block, True, n // block, fused_group(block))
    tiles = -(-n // TILE)
    span_tiles = -(-tiles // max(1, min(max_grid, tiles)))
    return Geometry(n, block, False, -(-tiles // span_tiles),
                    span=span_tiles * TILE)


_MAX_GRID: Dict[Tuple[int, int, bool], int] = {}


def _max_grid(dev: torch.device, dtype: int, vec: bool) -> int:
    """Resident CTAs of the cooperative kernel on ``dev`` (asked once)."""
    key = (dev.index, dtype, vec)
    if key not in _MAX_GRID:
        out = _INT(0)
        with torch.cuda.device(dev):
            code = _lib().quantize_max_grid(dtype, int(vec),
                                            ctypes.byref(out))
        if code != 0 or out.value < 1:
            raise RuntimeError(f"quantize occupancy query failed: "
                               f"cudaError {code}, {out.value} CTAs")
        _MAX_GRID[key] = out.value
    return _MAX_GRID[key]


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
    if n == 0:
        return q, scales
    dtype = _DTYPES[x.dtype]
    geo = launch_geometry(n, block, 1 if block <= TILE else
                          _max_grid(dev, dtype, x.data_ptr() % 16 == 0))
    partials = torch.empty(geo.partials, dtype=torch.float32, device=dev)
    code = _lib().quantize_launch(x.data_ptr(), q.data_ptr(),
                                  scales.data_ptr(), partials.data_ptr(), n,
                                  block, geo.grid, geo.span, geo.group,
                                  dtype, _stream(dev))
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
