"""The working precision of the port's plain paths.

The model code takes its sensitive steps (norms, softmax, rotations, the
SSD scan, the loss) in float32 whatever the weights' dtype.  It writes
that step as :func:`compute`, which is ``t.float()`` except that a
float64 tensor stays float64, so the plain path run on float64 weights
computes every step in float64: the yardstick the float32 paths are
measured against (``chip_smoke.py`` phase 13,
``tests/test_torch_grad_yardstick.py``).  For float32 and bfloat16 inputs
nothing changes.
"""

from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 for float64, float32 for everything else."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def compute(t: torch.Tensor) -> torch.Tensor:
    """``t`` in :func:`compute_dtype` of its dtype."""
    return t if t.dtype == torch.float64 else t.float()
