"""Public wrappers around the port's kernels: what the protocol core and
the model call.  Each takes CUDA tensors to its Hopper kernel and CPU
tensors to its plain version (see the kernel modules); a model site
takes ``meta`` tensors to the dry-run's meta launch
(:mod:`repro_torch.kernels.meta`); :data:`PLAIN`
maps the kernel sites of the models and of the gradient reduction to
the plain versions for ``Runtime(kernels="plain")``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import smc_sweep as _ss
from repro_torch.kernels import ssd_scan as _sc

KERNEL_MODULES = (_ss, _fd, _rn, _fa, _sc, _qz)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel in this process, by name."""
    counts: Dict[str, int] = {}
    for mod in KERNEL_MODULES:
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES:
        mod.reset_launch_counts()


def smc_sweep(counters: torch.Tensor, processed: torch.Tensor
              ) -> torch.Tensor:
    """Batched receive-predicate sweep over an explicit (S, W) ring."""
    return _ss.smc_sweep(counters, processed)


def smc_sweep_watermark(published: torch.Tensor, processed: torch.Tensor, *,
                        window: int, valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Receive sweep from published watermarks only — the counter ring is
    rebuilt inside the kernel.  The ``kernel`` Group backend's per-round
    receive predicate.  ``valid`` (bool or int) masks padded
    (member, sender) lanes in stacked multi-subgroup execution."""
    if valid is not None:
        valid = valid.to(torch.int32)
    return _ss.smc_sweep_watermark(published, processed, window=window,
                                   valid=valid)


def _row_lengths(kv_len, q: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) length as the (B,) int32 the kernel takes.  A
    contiguous (B,) int32 tensor on q's device (the decode step's
    ``position + 1``) passes through with no ATen call."""
    if isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32 \
            and kv_len.dim() == 1 and kv_len.is_contiguous():
        dev = q.get_device()
        if kv_len.get_device() == dev and (dev >= 0
                                           or kv_len.device == q.device):
            return kv_len
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(q.shape[0])
    return kv_len.to(torch.int32).contiguous()


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """q (B, Hq, D); caches (B, S_max, Hkv, D) in the model's layout,
    read through their strides; kv_len (B,) -> (B, Hq, D).  A scalar
    length is broadcast over the rows."""
    return _fd.flash_decode(q, k_cache, v_cache, _row_lengths(kv_len, q))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) -> same shape."""
    return _rn.rms_norm(x, weight, eps)


def rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6):
    """``r = residual + x`` -> ``(rms_norm(r), r)``."""
    return _rn.rms_norm_residual(x, residual, weight, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, Hq, D); k/v (B, S, Hkv, D) in the model's layout, read
    through their strides -> (B, S, Hq, D)."""
    return _fa.flash_attention(q, k, v, causal)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor, chunk: int):
    """Mamba2 SSD scan; same signature as ``models.ssm.ssd_chunked`` ->
    (y (B, S, H, P), final state (B, H, P, N) float32)."""
    return _sc.ssd_scan(x, dt, a_log, b, c, d_skip, dt_bias, chunk)


def quantize(x: torch.Tensor, block: int):
    """Block-scaled int8 quantize: x (n,) -> (q (n,) int8, scales
    (n / block,) float32)."""
    return _qz.quantize(x, block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse of :func:`quantize`, in ``out_dtype``."""
    return _qz.dequantize(q, scales, block, out_dtype)


def _flash_decode_plain(q, k_cache, v_cache, kv_len):
    return _fd.flash_decode_plain(q, k_cache, v_cache,
                                  _row_lengths(kv_len, q))


PLAIN = {
    "flash_decode": _flash_decode_plain,
    "rms_norm": _rn.rms_norm_plain,
    "rms_norm_residual": _rn.rms_norm_residual_plain,
    "flash_attention": _fa.flash_attention_plain,
    "ssd_scan": _sc.ssd_scan_plain,
    "quantize": _qz.quantize_plain,
    "dequantize": _qz.dequantize_plain,
}
