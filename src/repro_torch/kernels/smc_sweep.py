"""SMC receive sweep: the Hopper kernels, their plain PyTorch twins, and
the wrappers that choose between them.

Two functions, as in the reference's ``repro.kernels.smc_sweep``:

* :func:`smc_sweep` sweeps an explicit (S, W) slot-counter ring (the real
  SMC data structure, e.g. one built by :func:`repro_torch.core.smc.publish`
  or :func:`counters_from_counts`).
* :func:`smc_sweep_watermark` sweeps from per-lane published watermarks
  only.  The kernel computes the run in closed form
  (:func:`smc_sweep_watermark_closed_form`, which the CPU tests hold
  against the plain twin's loop over the materialized ring), so nothing
  (L, W)-shaped exists and a lane's cost does not depend on W.  This is
  the receive predicate of the ``kernel`` Group backend, launched once
  per round; its launch path is one ``torch.empty_like`` and one ctypes
  call with the arguments packed into one array.

A wrapper given CPU tensors runs the plain twin; given CUDA tensors it
launches the kernel from ``csrc/smc_sweep.cu`` (built at first use) or
raises.  There is no fallback from the card to the twin.  Each launch adds
one to the module's launch counter; twins count nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

# Launches of each CUDA kernel in this process (twins do not count).
WATERMARK_LAUNCHES = 0
RING_LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the watermark entry point takes one packed int64 array (no argtypes: no
# per-call conversion of arguments): published, processed, valid (0 = no
# mask), out, lanes, window, stream
_N_WATERMARK_ARGS = 7
_SIGNATURES = {
    "smc_sweep_watermark_launch": (None, _INT),
    "smc_sweep_ring_launch": ([_PTR, _PTR, _PTR, _INT, _INT, _PTR], _INT),
}


def launch_counts() -> Dict[str, int]:
    return {"smc_sweep_watermark": WATERMARK_LAUNCHES,
            "smc_sweep": RING_LAUNCHES}


def reset_launch_counts() -> None:
    global WATERMARK_LAUNCHES, RING_LAUNCHES
    WATERMARK_LAUNCHES = 0
    RING_LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    """The kernel library, built from source at first use."""
    return _build.load("smc_sweep", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


# ---------------------------------------------------------------------------
# plain twins (the reference arithmetic, in torch)
# ---------------------------------------------------------------------------

def counters_from_counts(published: torch.Tensor, window: int) -> torch.Tensor:
    """Materialize the SMC slot-counter ring a receiver would observe after
    ``published`` messages from each sender.

    published: (S,) int32 counts -> (S, W) int32 counters.  Slot ``j``
    holds the counter of the latest message index ``k < published`` with
    ``k % W == j`` (-1 if the slot was never written).
    """
    slots = torch.arange(window, device=published.device,
                         dtype=torch.int32)[None, :]
    pub = published.to(torch.int32)[:, None]
    return torch.where(pub > slots, (pub - 1 - slots) // window, -1)


def _contiguous_run(counters: torch.Tensor, processed: torch.Tensor,
                    window: int) -> torch.Tensor:
    """Length of the contiguous visible run starting at ``processed``
    given an (L, W) counter tile."""
    j = torch.arange(window, device=processed.device, dtype=torch.int32)
    ks = processed[:, None] + j
    # take_along_dim indexes with int64; the values compared stay int32
    slots = (ks % window).long()
    have = torch.take_along_dim(counters, slots, dim=1) >= ks // window
    run = torch.cumprod(have.to(torch.int32), dim=1, dtype=torch.int32)
    return run.sum(dim=1, dtype=torch.int32)


def smc_sweep_plain(counters: torch.Tensor,
                    processed: torch.Tensor) -> torch.Tensor:
    """Twin of the ring kernel: (S, W) counters, (S,) processed -> (S,)."""
    return processed + _contiguous_run(counters, processed, counters.shape[1])


def smc_sweep_watermark_closed_form(published: torch.Tensor,
                                    processed: torch.Tensor, window: int,
                                    valid: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """What the watermark kernel computes, lane by lane: ``processed +
    clamp(max(published, 0) - processed, 0, W)`` in 64-bit arithmetic,
    wrapped to int32; ``processed`` where ``valid <= 0``.  Slot ``k`` is
    visible iff ``k < max(published, 0)``, so the run is the count of
    leading ``k = processed + j`` below that limit.  The tests hold it
    against :func:`smc_sweep_watermark_plain` and the reference's Pallas
    kernel; nothing on the main path calls it."""
    pub, proc = published.long(), processed.long()
    run = (pub.clamp(min=0) - proc).clamp(0, window)
    if valid is not None:
        run = torch.where(valid > 0, run, 0)
    out = (proc + run + (1 << 31)) % (1 << 32) - (1 << 31)
    return out.to(torch.int32)


def smc_sweep_watermark_plain(published: torch.Tensor,
                              processed: torch.Tensor, window: int,
                              valid: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Twin of the watermark kernel: (L,) published/processed[/valid] ->
    (L,).  An invalid lane returns ``processed`` unchanged."""
    run = _contiguous_run(counters_from_counts(published, window),
                          processed, window)
    if valid is not None:
        run = torch.where(valid > 0, run, 0)
    return processed + run


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_lanes(window: int, **tensors: Optional[torch.Tensor]) -> int:
    """Validate 1-D int32 contiguous same-device same-length operands;
    returns the lane count."""
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be an int >= 1, got {window!r}")
    given = {k: t for k, t in tensors.items() if t is not None}
    first = next(iter(given.values()))
    for name, t in given.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
        if t.shape != first.shape:
            raise ValueError(f"lane counts differ: {name} has {t.shape[0]}, "
                             f"expected {first.shape[0]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{first.device}")
    return first.shape[0]


def _check_launch(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")


_LOCAL = threading.local()


def _watermark_caller():
    """This thread's (packed argument array, the C function): the array
    is filled and read within one call, so each thread has its own."""
    try:
        return _LOCAL.caller
    except AttributeError:
        _LOCAL.caller = ((ctypes.c_longlong * _N_WATERMARK_ARGS)(),
                         _lib().smc_sweep_watermark_launch)
        return _LOCAL.caller


def _lanes_match(t: torch.Tensor, like: torch.Tensor) -> bool:
    """Whether ``t`` is a contiguous int32 tensor of ``like``'s shape on
    its device (attribute reads only)."""
    return (type(t) is torch.Tensor and t.dtype is torch.int32
            and t.shape == like.shape and t.is_contiguous()
            and t.get_device() == like.get_device())


def _check_watermark(published, processed, valid) -> None:
    """The watermark wrapper's operand checks, kept to attribute reads
    (it runs once per protocol round); anything off re-runs the full
    check for its message."""
    if not (published.dim() == 1 and _lanes_match(published, published)
            and _lanes_match(processed, published)
            and (valid is None or _lanes_match(valid, published))
            and published.device == processed.device):
        _check_lanes(1, published=published, processed=processed,
                     valid=valid)


def smc_sweep_watermark(published: torch.Tensor, processed: torch.Tensor, *,
                        window: int, valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """published/processed (and optional valid, nonzero = real lane):
    (L,) int32 -> visible counts (L,) int32.  CPU tensors run the plain
    twin; CUDA tensors launch the kernel on the current stream."""
    global WATERMARK_LAUNCHES
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be an int >= 1, got {window!r}")
    if not isinstance(published, torch.Tensor):
        raise TypeError("published must be a torch.Tensor")
    _check_watermark(published, processed, valid)
    if published.is_cuda:
        out = torch.empty_like(processed)
        n = out.shape[0]
        if n:
            args, fn = _watermark_caller()
            dev = published.get_device()
            args[:] = (published.data_ptr(), processed.data_ptr(),
                       0 if valid is None else valid.data_ptr(),
                       out.data_ptr(), n, window,
                       torch._C._cuda_getCurrentRawStream(dev))
            if dev == torch._C._cuda_getDevice():
                code = fn(args)
            else:
                with torch.cuda.device(dev):
                    code = fn(args)
            _check_launch(code, "smc_sweep_watermark")
            WATERMARK_LAUNCHES += 1
        return out
    if published.device.type == "cpu":
        return smc_sweep_watermark_plain(published, processed, window, valid)
    raise ValueError(f"no smc_sweep_watermark for device {published.device}")


def smc_sweep(counters: torch.Tensor, processed: torch.Tensor
              ) -> torch.Tensor:
    """counters: (S, W) int32 slot counters; processed: (S,) int32 ->
    visible counts (S,) int32.  CPU tensors run the plain twin; CUDA
    tensors launch the kernel on the current stream."""
    global RING_LAUNCHES
    if not isinstance(counters, torch.Tensor) or counters.dim() != 2:
        raise ValueError("counters must be a 2-D (S, W) tensor")
    if counters.dtype != torch.int32 or not counters.is_contiguous():
        raise TypeError("counters must be contiguous int32")
    window = counters.shape[1]
    n = _check_lanes(window, processed=processed)
    if counters.shape[0] != n or counters.device != processed.device:
        raise ValueError(f"counters {tuple(counters.shape)} on "
                         f"{counters.device} do not match processed "
                         f"({n},) on {processed.device}")
    dev = processed.device
    if dev.type == "cpu":
        return smc_sweep_plain(counters, processed)
    if dev.type != "cuda":
        raise ValueError(f"no smc_sweep for device {dev}")
    out = torch.empty_like(processed)
    if n == 0:
        return out
    lib = _lib()
    _check_launch(lib.smc_sweep_ring_launch(
        counters.data_ptr(), processed.data_ptr(), out.data_ptr(), n, window,
        torch.cuda.current_stream(dev).cuda_stream), "smc_sweep")
    RING_LAUNCHES += 1
    return out
