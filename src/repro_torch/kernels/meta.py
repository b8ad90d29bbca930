"""The kernel sites on the ``meta`` device: the dry-run's stand-in for a
launch.

On ``meta`` tensors a kernel wrapper computes nothing and launches
nothing: it returns empty ``meta`` outputs of the kernel's shapes and
dtypes and reports one op to every active analysis
(:class:`repro_torch.launch.opanalysis.OpAnalysis`): the kernel's name,
its tensor-core FLOPs (the products it computes, by the formulas below)
and its operands' and results' bytes.  A wrapper that has a gradient
wraps the meta launch in
:func:`repro_torch.kernels.autograd.kernel_with_plain_grad`, as on the
card, so a traced train step runs the plain backward the card runs.
Nothing here touches a device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

# the analyses a meta launch reports to (OpAnalysis pushes itself here
# while it is active)
SINKS: List = []

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def empty(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def launch(name: str, inputs: Sequence[torch.Tensor], outputs: Outputs,
           dot_flops: int = 0) -> Outputs:
    """Report one kernel op to every active analysis and return
    ``outputs``."""
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    for sink in SINKS:
        sink.kernel_op(name, inputs, outs, dot_flops)
    return outputs


def attention_flops(b: int, s: int, hq: int, d: int, causal: bool) -> int:
    """Flash attention's QK^T and PV over the (query, key) pairs the
    mask keeps (the kernel skips the tiles above the diagonal)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * hq * d * pairs


def decode_flops(b: int, hq: int, d: int, s: int) -> int:
    """Flash decode's q k^T and p v over ``s`` cache positions a row (on
    ``meta`` the lengths are unknown: the whole cache is counted)."""
    return 4 * b * hq * d * s


def ssd_flops(b: int, s: int, h: int, p: int, n: int, g: int,
              chunk: int) -> int:
    """The SSD scan's matrix work: the causal C B^T scores once per group
    (every head of a group shares them), their product with x dt, and
    the inbound-state and state-update terms per head."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = g * 2 * n * pairs + h * (2 * p * pairs + 4 * chunk * n * p)
    return b * (s // chunk) * per_chunk
