"""Plain oracles for the port's kernels (the exact-match ground truth)."""

from __future__ import annotations

import torch

from repro_torch.core.smc import visible_from_counters


def smc_sweep_ref(counters: torch.Tensor,
                  processed: torch.Tensor) -> torch.Tensor:
    """The receive predicate's contiguous scan over an (S, W) ring."""
    w = counters.shape[-1]
    return visible_from_counters(counters, processed, w).to(torch.int32)
