"""Validity-masked decode-state updates, as in-place row operations.

The serve plane's slot ring decodes every slot of the batch each round,
active or not; a slot that is not ``valid`` must carry its decode state
through bit-unchanged (the null-round no-op).  The reference expresses
that as ``where(valid, new, old)`` over the whole cache, which copies the
cache every step — at 8 slots x 2048 positions of qwen3-1.7b that is
1.9 GB per replica per step.  Here both operations touch only the rows
they change, along each leaf's ``"batch"`` axis:

* :func:`reset_rows` zeroes the admitted slots' rows (the admission
  reset);
* :func:`masked_update` copies the valid rows of ``new`` into ``old``
  and is a no-op when ``new`` IS ``old`` — the decoder writes the valid
  rows in place already (:func:`repro_torch.models.attention.
  decode_attention`).

``valid`` is a host-side ``(B,)`` bool vector (numpy, a list or a CPU
tensor), so picking the rows costs no device synchronisation.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import ParamSpec, map_specs

PyTree = Any


def batch_axis(spec: ParamSpec) -> int:
    """Index of the ``"batch"`` axis in a cache leaf's logical axes."""
    if "batch" not in spec.axes:
        raise ValueError(f"cache leaf has no batch axis: {spec.axes}")
    return spec.axes.index("batch")


def valid_rows(valid, device) -> Optional[torch.Tensor]:
    """The indices where a host-side ``(B,)`` bool ``valid`` holds, as a
    1-D int64 tensor on ``device`` (``None`` for ``valid=None``, meaning
    every row)."""
    if valid is None:
        return None
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    idx = np.flatnonzero(np.asarray(valid, bool))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def reset_rows(specs: PyTree, cache: PyTree, valid) -> PyTree:
    """Zero, in place, the cache rows of slots where ``valid`` — the
    admission reset.  Returns ``cache``."""

    def leaf(spec, c):
        rows = valid_rows(valid, c.device)
        c.index_fill_(batch_axis(spec), rows, 0)
        return c

    return map_specs(leaf, specs, cache)


def masked_update(specs: PyTree, old: PyTree, new: PyTree,
                  valid) -> PyTree:
    """``where(valid, new, old)`` per cache leaf, written into ``old`` in
    place: only the valid rows are copied, the others stay bit-for-bit.
    A leaf whose ``new`` is ``old`` itself (updated in place by the
    decoder) is left as it is.  Returns ``old``."""

    def leaf(spec, o, n):
        if n is not o:
            ax = batch_axis(spec)
            rows = valid_rows(valid, o.device)
            o.index_copy_(ax, rows, n.index_select(ax, rows))
        return o

    return map_specs(leaf, specs, old, new)
