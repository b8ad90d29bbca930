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
given CPU tensors runs it; given CUDA tensors it launches the kernels
from ``csrc/ssd_scan.cu`` (built at first use) or raises.  There is no
fallback from the card to the plain version.  With grad mode on and an
input that requires a gradient, the kernel's outputs carry the plain
version's gradient
(:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`).

On the card one call runs the chunked SSD's four steps as four kernels
on the current stream (the C Bᵀ scores once per group, each chunk's own
state, the state passed from chunk to chunk, the outputs); their
intermediates live in a workspace allocated with the outputs in one
buffer (:func:`workspace_layout`).  Each call adds one to
:data:`LAUNCHES`.  The kernels take P and N that are multiples of 16 up
to 128 and 256 (:func:`check_kernel_shape`) and any chunk dividing S up
to 4096.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import kernel_with_plain_grad

# Launches of the CUDA kernel in this process (the plain version counts
# nothing).
LAUNCHES = 0

# one packed int64 array (no argtypes: no per-call conversion of
# arguments); its layout is in csrc/ssd_scan.cu above ssd_scan_launch
_N_ARGS = 37
_SIGNATURES = {"ssd_scan_launch": (None, ctypes.c_int)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 128, 256
MAX_CHUNK = 4096


def launch_counts() -> Dict[str, int]:
    return {"ssd_scan": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", _SIGNATURES)


def kernel_shape_ok(p: int, n: int, chunk: int) -> bool:
    """Whether the kernels take head dim P, state dim N and this chunk:
    P and N multiples of 16 up to :data:`MAX_P` and :data:`MAX_N`, the
    chunk up to :data:`MAX_CHUNK`."""
    return (p % 16 == 0 and 16 <= p <= MAX_P and n % 16 == 0
            and 16 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK)


def check_kernel_shape(p: int, n: int, chunk: int) -> None:
    if not kernel_shape_ok(p, n, chunk):
        raise ValueError(
            f"the ssd_scan kernels take P a multiple of 16 up to {MAX_P}, "
            f"N a multiple of 16 up to {MAX_N} and chunk <= {MAX_CHUNK}; "
            f"got P={p}, N={n}, chunk={chunk}")


def _bytes(shape, dtype) -> int:
    numel = 1
    for d in shape:
        numel *= d
    return numel * dtype.itemsize


def workspace_layout(bsz: int, s: int, h: int, p: int, n: int, g: int,
                     chunk: int, dtype: torch.dtype) -> Dict[str, Tuple]:
    """``{name: (byte offset, shape, dtype)}`` of the outputs and the
    workspace in the one buffer a call allocates, each part 256-byte
    aligned: y (B, S, H, P) and the final state (B, H, P, N) first, then
    the scores (B, nc, G, LP, LP) in the operand dtype, LP the chunk
    rounded up to 64, the
    prefix sums cs, softplus(dt + bias) and the state's weights
    dts exp(cs_last - cs) (B, H, S), each chunk's own state
    (B, nc, H, P, N) in float32 and the state entering each chunk in the
    operand dtype."""
    nc, lp = s // chunk, -(-chunk // 64) * 64
    f32 = torch.float32
    parts = (("y", (bsz, s, h, p), dtype), ("state", (bsz, h, p, n), f32),
             ("scores", (bsz, nc, g, lp, lp), dtype),
             ("cs", (bsz, h, s), f32),
             ("dts", (bsz, h, s), f32), ("w", (bsz, h, s), f32),
             ("local", (bsz, nc, h, p, n), f32),
             ("s_in", (bsz, nc, h, p, n), dtype))
    out, off = {}, 0
    for name, shape, dt in parts:
        out[name] = (off, shape, dt)
        off += -(-_bytes(shape, dt) // 256) * 256
    out["total"] = (off, (), torch.uint8)
    return out


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


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh contiguous copy where its base or a stride of its
    leading dims is not a whole number of 16 bytes (the kernels copy rows
    of x, b and c in 16-byte pieces)."""
    esize = t.element_size()
    if t.data_ptr() % 16 or any(st * esize % 16 for st, k in
                                zip(t.stride()[:-1], t.shape[:-1]) if k > 1):
        return t.clone(memory_format=torch.contiguous_format)
    return t


_LOCAL = threading.local()


def _caller():
    """This thread's (packed argument array, the C function)."""
    try:
        return _LOCAL.caller
    except AttributeError:
        _LOCAL.caller = ((ctypes.c_longlong * _N_ARGS)(),
                         _lib().ssd_scan_launch)
        return _LOCAL.caller


def _launch(x, dt, a_log, b, c, d_skip, dt_bias, chunk: int,
            workspace: bool = False):
    """One allocation and one ctypes call that launches the four kernels;
    returns (y, state), or with ``workspace`` the dict of every part of
    the buffer (for the self-check; counts no launch)."""
    global LAUNCHES
    dev = x.device
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    check_kernel_shape(p, n, chunk)
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("ssd_scan needs unit-stride last dims of x, b, c")
    x, b, c = (_aligned_rows(t) for t in (x, b, c))
    a_log, d_skip, dt_bias = (
        t if t.dtype == torch.float32 and t.is_contiguous()
        else t.float().contiguous() for t in (a_log, d_skip, dt_bias))
    if dt.dtype not in _DTYPES:
        dt = dt.float()
    layout = workspace_layout(bsz, s, h, p, n, g, chunk, x.dtype)
    buf = torch.empty(layout["total"][0], dtype=torch.uint8, device=dev)
    parts = {name: buf[off:off + _bytes(shape, dt_)].view(dt_).view(shape)
             for name, (off, shape, dt_) in layout.items()
             if name != "total"}
    y, state = parts["y"], parts["state"]
    if bsz == 0 or s == 0:
        return parts if workspace else (y, state.zero_())
    args, fn = _caller()
    base = buf.data_ptr()
    ptr = {name: base + off for name, (off, _, _) in layout.items()}
    args[:] = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
               c.data_ptr(), d_skip.data_ptr(), dt_bias.data_ptr(),
               ptr["y"], ptr["state"], ptr["scores"], ptr["cs"], ptr["dts"],
               ptr["w"], ptr["local"], ptr["s_in"], bsz, s, h, g, p, n, chunk,
               _DTYPES[x.dtype], _DTYPES[dt.dtype], *x.stride()[:3],
               *dt.stride(), *b.stride()[:3], *c.stride()[:3],
               torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch._C._cuda_getDevice():
        code = fn(args)
    else:
        with torch.cuda.device(dev):
            code = fn(args)
    if code != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {code}")
    if workspace:
        return parts
    LAUNCHES += 1
    return y, state


def stage_check(x, dt, a_log, b, c, d_skip, dt_bias, chunk: int
                ) -> Dict[str, torch.Tensor]:
    """Launch the kernels once on CUDA tensors and return every part of
    their buffer (y, state, scores, cs, dts, local, s_in) for a check of
    each step against plain products (``kernels/selfcheck.py``).  Counts
    no launch."""
    _check(x, dt, a_log, b, c, d_skip, dt_bias, chunk)
    return _launch(x, dt, a_log, b, c, d_skip, dt_bias, chunk,
                   workspace=True)
