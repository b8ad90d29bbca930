"""Plain oracles for the port's kernels (the ground truth the kernels are
held against): each kernel's plain PyTorch version, under the
reference's ``*_ref`` names."""

from __future__ import annotations

import torch

from repro_torch.core.smc import visible_from_counters
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention_ref
from repro_torch.kernels.flash_decode import \
    flash_decode_plain as flash_decode_ref
from repro_torch.kernels.quantize import \
    dequantize_plain as dequantize_ref
from repro_torch.kernels.quantize import quantize_plain as quantize_ref
from repro_torch.kernels.rmsnorm import rms_norm_plain as rms_norm_ref
from repro_torch.kernels.rmsnorm import \
    rms_norm_residual_plain as rms_norm_residual_ref
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_scan_ref

__all__ = ["dequantize_ref", "flash_attention_ref", "flash_decode_ref",
           "quantize_ref", "rms_norm_ref",
           "rms_norm_residual_ref", "smc_sweep_ref", "ssd_scan_ref",
           "ssd_sequential_ref"]


def smc_sweep_ref(counters: torch.Tensor,
                  processed: torch.Tensor) -> torch.Tensor:
    """The receive predicate's contiguous scan over an (S, W) ring."""
    w = counters.shape[-1]
    return visible_from_counters(counters, processed, w).to(torch.int32)


def ssd_sequential_ref(x, dt, a_log, b, c, d_skip, dt_bias):
    """O(S) step-by-step recurrence — the definitional oracle of the SSD
    scan."""
    from repro_torch.models.ssm import ssd_decode_step
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(x[:, t], dt[:, t], a_log, b[:, t],
                                   c[:, t], d_skip, dt_bias, state)
        ys.append(y)
    return torch.stack(ys, dim=1), state
