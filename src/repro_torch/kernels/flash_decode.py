"""Flash decode: one-token GQA attention over a KV cache with a per-row
length — the Hopper kernel, its plain PyTorch version, and the wrapper
that chooses between them.

Replaces ``repro.kernels.flash_decode.flash_decode_flat`` (TPU).  Where
that kernel took a scalar ``kv_len`` and a cache transposed and padded to
``(B*Hkv, S, D)``, :func:`flash_decode` takes the model's layout as it
is — q ``(B, Hq, D)``, caches ``(B, S_max, Hkv, D)`` — and a ``(B,)``
int32 ``kv_len``; a scalar length is the special case of equal rows.

The wrapper given CPU tensors runs :func:`flash_decode_plain`; given
CUDA tensors it launches the kernels of ``csrc/flash_decode.cu`` (built
at first use) or raises.  The keys are split into chunks over blocks
(:func:`launch_geometry`) and, where there is more than one chunk, a
merge kernel combines the chunks' partial softmaxes; both are launched
by one ctypes call with its arguments packed into one array, and the
partials' workspace shares one allocation with the output.  There is no
fallback from the card to the plain version.  One-token decode has no
gradient (the reference does not differentiate it either): the wrapper
raises rather than drop one.  Each call that launches adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.autograd import refuse_grad
from repro_torch.precision import compute

NEG_INF = -1e30

# Launches of the CUDA kernels in this process, one per wrapper call that
# launched (the split kernel and, with it, the merge); the plain version
# counts nothing.
LAUNCHES = 0

# launch_args' 23 values, the stream, and the scale (a double, in the last
# slot); no argtypes: the packed array is passed as its pointer
_N_ARGS = 25
_SIGNATURES = {"flash_decode_launch": (None, ctypes.c_int)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor base class: a cheaper isinstance check than torch.Tensor's
_TENSOR = getattr(torch._C, "TensorBase", torch.Tensor)
# the shapes the kernels take: head dims that are multiples of
# HEAD_DIM_STEP up to MAX_HEAD_DIM, and Hq / Hkv from 1 to MAX_GROUP
HEAD_DIM_STEP = 8
MAX_HEAD_DIM = 256
MAX_GROUP = 16
# keys a block takes: at least MIN_CHUNK, and at most MAX_CHUNKS chunks
# (the merge kernel's kMaxChunks)
MIN_CHUNK = 128
MAX_CHUNKS = 64


def launch_counts() -> Dict[str, int]:
    return {"flash_decode": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load("flash_decode", _SIGNATURES)


def build() -> None:
    """Compile and load the kernel library now (it is otherwise built at
    the first CUDA launch)."""
    _lib()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """The masked softmax of the reference's ``_sdpa`` decode case,
    accumulated in float32 (float64 for float64 inputs): q (B, Hq, D),
    caches (B, S, Hkv, D), kv_len (B,) -> (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = compute(q).reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bthd->bhgt", qg, compute(k_cache))
    scores = scores / math.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] < \
        kv_len.to(q.device)[:, None]                          # (B, S)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, compute(v_cache))
    return out.reshape(b, hq, d).to(q.dtype)


def _check(q, k_cache, v_cache, kv_len) -> None:
    """Validate the wrapper's inputs on any device.  Kept to cheap
    attribute reads: it runs 28 times a decode step."""
    T = _TENSOR
    if not (isinstance(q, T) and isinstance(k_cache, T)
            and isinstance(v_cache, T) and isinstance(kv_len, T)):
        raise TypeError("q, k_cache, v_cache and kv_len must be tensors")
    # get_device is the CUDA index, -1 off the card: compare devices in
    # full only there
    dev = q.get_device()
    if k_cache.get_device() != dev or v_cache.get_device() != dev or \
            kv_len.get_device() != dev or (dev < 0 and not (
                k_cache.device == v_cache.device == kv_len.device
                == q.device)):
        raise ValueError(f"q is on {q.device}, k_cache on {k_cache.device}, "
                         f"v_cache on {v_cache.device}, kv_len on "
                         f"{kv_len.device}")
    q_shape, k_shape = q.shape, k_cache.shape
    if len(q_shape) != 3 or len(k_shape) != 4:
        raise ValueError(f"q must be (B, Hq, D) and the caches "
                         f"(B, S, Hkv, D); got {tuple(q_shape)} and "
                         f"{tuple(k_shape)}")
    if k_shape != v_cache.shape:
        raise ValueError(f"k_cache {tuple(k_shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    b, hq, d = q_shape
    kb, _, hkv, kd = k_shape
    if kb != b or kd != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q_shape)} does not fit caches "
                         f"{tuple(k_shape)}")
    if kv_len.dtype != torch.int32 or kv_len.dim() != 1 or \
            kv_len.shape[0] != b:
        raise ValueError(f"kv_len must be ({b},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    dtype = q.dtype
    if dtype not in _DTYPES or k_cache.dtype != dtype or \
            v_cache.dtype != dtype:
        raise TypeError(f"q and the caches must share float32 or bfloat16; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def check_kernel_shape(d: int, group: int) -> None:
    """Raise unless the kernels take head dim ``d`` and ``group`` query
    heads a kv head: d a multiple of 8 from 8 to 256, group from 1 to
    16 (the ported configs' heads and zamba2's D = 80)."""
    if d % HEAD_DIM_STEP or not HEAD_DIM_STEP <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash_decode kernel takes a head dim that is "
                         f"a multiple of {HEAD_DIM_STEP} up to "
                         f"{MAX_HEAD_DIM}; got D={d}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"the flash_decode kernel takes Hq/Hkv from 1 to "
                         f"{MAX_GROUP}; got group={group}")


@functools.lru_cache(maxsize=None)
def launch_geometry(s_max: int, d: int,
                    dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(chunk, n_chunks, tile)`` for caches of ``s_max`` positions and
    head dim d: keys a block takes (at least :data:`MIN_CHUNK`, a multiple
    of 64, grown so that there are at most :data:`MAX_CHUNKS`), chunks
    covering ``s_max`` (at least one), and keys a shared-memory tile holds
    (64 for K/V rows of up to 256 bytes, 32 up to 512, else 16: at most
    16 KB of K a stage).  From the cache's shape alone: the lengths stay
    on the card."""
    row = d * (4 if dtype == torch.float32 else 2)
    tile = 64 if row <= 256 else 32 if row <= 512 else 16
    chunk = max(MIN_CHUNK, -(-s_max // MAX_CHUNKS))
    chunk = -(-chunk // 64) * 64
    return chunk, max(1, -(-s_max // chunk)), tile


def workspace_floats(b: int, hq: int, d: int, n_chunks: int) -> int:
    """float32 values of the partials (acc, then m and l of each query
    head and chunk); none for one chunk."""
    return 0 if n_chunks == 1 else b * hq * n_chunks * (d + 2)


def launch_args(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, kv_len: torch.Tensor, out_ptr: int,
                ws_ptr: int) -> Tuple[int, ...]:
    """``flash_decode_launch``'s packed arguments: pointers of q, the
    caches, kv_len, the output and the workspace, B, Hkv, group, S_max,
    D, the dtype code, :func:`launch_geometry`, then the strides q_sb,
    q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh in elements.  Raises unless
    the head dims have unit stride and the caches' rows are 16-byte
    aligned (the kernel copies cache rows in 16-byte pieces and reads q
    by element)."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    if qs[2] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("flash_decode needs a unit-stride head dim")
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    # strides in whole 16-byte units: 16 / esize elements, a power of two
    unit = 16 // k_cache.element_size()
    if (k_ptr | v_ptr) % 16 or \
            (ks[0] | ks[1] | ks[2] | vs[0] | vs[1] | vs[2]) % unit:
        raise ValueError("flash_decode needs 16-byte aligned cache rows (a "
                         "base and strides that are multiples of 16 bytes)")
    return (q.data_ptr(), k_ptr, v_ptr, kv_len.data_ptr(), out_ptr, ws_ptr,
            b, hkv, hq // hkv, s, d, _DTYPES[q.dtype],
            *launch_geometry(s, d, q.dtype), qs[0], qs[1], ks[0], ks[1],
            ks[2], vs[0], vs[1], vs[2])


_LOCAL = threading.local()


def _caller():
    """This thread's (argument array, a float64 view of its last slot, the
    C function): the array is filled and read within one call, so each
    thread has one."""
    try:
        return _LOCAL.caller
    except AttributeError:
        buf = (ctypes.c_longlong * _N_ARGS)()
        scale = ctypes.c_double.from_buffer(buf, 8 * (_N_ARGS - 1))
        _LOCAL.caller = buf, scale, _lib().flash_decode_launch
        return _LOCAL.caller


def _launch(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """One allocation (the output, and the chunks' partials behind it
    where there is more than one chunk) and one ctypes call."""
    global LAUNCHES
    args = launch_args(q, k_cache, v_cache, kv_len, 0, 0)
    b, d, n_chunks = args[6], args[10], args[13]
    check_kernel_shape(d, args[8])
    if n_chunks == 1:
        out = (torch.empty_like(q) if q.is_contiguous() else
               torch.empty_like(q, memory_format=torch.contiguous_format))
        ws_ptr = 0
    else:
        hq, esize = q.shape[1], q.element_size()
        # the partials start at the first 16-byte boundary past the output
        off = -(-b * hq * d * esize // 16) * 16
        buf = q.new_empty(-(-(off + 4 * workspace_floats(b, hq, d, n_chunks))
                            // esize))
        out = buf.as_strided((b, hq, d), (hq * d, d, 1))
        ws_ptr = buf.data_ptr() + off
    if not b:
        return out
    buf_args, scale, fn = _caller()
    dev = q.get_device()
    buf_args[:-1] = args + (torch._C._cuda_getCurrentRawStream(dev),)
    buf_args[4] = out.data_ptr()
    buf_args[5] = ws_ptr
    scale.value = 1.0 / math.sqrt(d)
    if dev == torch._C._cuda_getDevice():
        code = fn(buf_args)
    else:
        with torch.cuda.device(dev):
            code = fn(buf_args)
    if code != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {code}")
    LAUNCHES += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor
                 ) -> torch.Tensor:
    """Attention of each row's one query token over the first
    ``kv_len[b]`` positions of its cache rows.  q (B, Hq, D); caches
    (B, S_max, Hkv, D), read through their strides (the head dim must be
    contiguous); kv_len (B,) int32 -> (B, Hq, D) in q's dtype.  CPU
    tensors run the plain version.  CUDA tensors launch the kernels on
    the current stream; they take a head dim D that is a multiple of 8
    from 8 to 256 and Hq/Hkv from 1 to 16, and raise outside that range
    (:func:`check_kernel_shape`), as on any device other than the CPU.
    There is no gradient: with grad mode on and an input that requires
    one, it raises."""
    _check(q, k_cache, v_cache, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        refuse_grad("flash_decode", q, k_cache, v_cache)
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, kv_len)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_len)
    check_kernel_shape(q.shape[2], q.shape[1] // k_cache.shape[2])
    raise ValueError(f"no flash_decode for device {q.device}")
