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
  decode_attention` for K/V, :func:`write_rows` for the recurrent
  families' states).

``valid`` comes in two forms:

* host rows: a ``(B,)`` bool vector in numpy or a list, so picking the
  rows costs no device synchronisation (the per-round serve loop);
* a device mask: a ``(B,)`` bool tensor, read only by device operations,
  so a step can be captured into a CUDA graph (the fused serve program,
  :mod:`repro_torch.serve.fused`).  Every row is then written as
  ``where(valid, new, old)``; the values of the valid rows, and the
  untouched bits of the others, are those of the host-row form.
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


def is_device_mask(valid) -> bool:
    """Whether ``valid`` (or the rows :func:`valid_rows` made of it) is
    the device-mask form: a bool tensor."""
    return isinstance(valid, torch.Tensor) and valid.dtype == torch.bool


def valid_rows(valid, device) -> Optional[torch.Tensor]:
    """The rows to write: for host rows, the indices where the ``(B,)``
    bool ``valid`` holds, as a 1-D int64 tensor on ``device``; a device
    mask is returned as it is (``None`` for ``valid=None``, meaning every
    row).  A tensor must be a bool mask on ``device``: anything else
    raises rather than being read on the host or taken for row
    indices."""
    if valid is None:
        return None
    if isinstance(valid, torch.Tensor):
        if valid.dtype != torch.bool:
            raise TypeError(f"a tensor valid must be a bool device mask, "
                            f"not {valid.dtype}")
        if valid.device != torch.device(device):
            raise ValueError(f"the valid mask is on {valid.device}, the "
                             f"rows it masks on {device}")
        return valid
    idx = np.flatnonzero(np.asarray(valid, bool))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _row_mask(spec: ParamSpec, c: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """A device mask shaped to broadcast along ``c``'s batch axis."""
    shape = [1] * c.dim()
    shape[batch_axis(spec)] = c.shape[batch_axis(spec)]
    return valid_rows(valid, c.device).reshape(shape)


def write_rows(dst: torch.Tensor, new: torch.Tensor, rows) -> None:
    """Write ``new``'s rows into ``dst`` (same shape, batch axis 0) in
    place, at ``rows`` as :func:`valid_rows` gives them: index rows are
    copied and no other row is touched; a device mask writes
    ``where(rows, new, dst)``; ``None`` writes every row."""
    if rows is None:
        dst.copy_(new)
    elif is_device_mask(rows):
        mask = rows.reshape(-1, *[1] * (dst.dim() - 1))
        dst.copy_(torch.where(mask, new.to(dst.dtype), dst))
    else:
        dst.index_copy_(0, rows, new.index_select(0, rows).to(dst.dtype))


def reset_rows(specs: PyTree, cache: PyTree, valid) -> PyTree:
    """Zero, in place, the cache rows of slots where ``valid`` — the
    admission reset.  Returns ``cache``."""

    def leaf(spec, c):
        if is_device_mask(valid):
            c.masked_fill_(_row_mask(spec, c, valid), 0)
        else:
            c.index_fill_(batch_axis(spec), valid_rows(valid, c.device), 0)
        return c

    return map_specs(leaf, specs, cache)


def reset_slot(specs: PyTree, cache: PyTree, b: int) -> PyTree:
    """Zero, in place, slot ``b``'s cache rows: the admission reset of
    one slot, for a caller that decides on the device whether it runs
    (the fused serve program: an IF node a slot, so a round writes only
    the rows it admits, not the whole cache a masked fill reads and
    writes).  Returns ``cache``."""

    def leaf(spec, c):
        c.select(batch_axis(spec), b).zero_()
        return c

    return map_specs(leaf, specs, cache)


def masked_update(specs: PyTree, old: PyTree, new: PyTree,
                  valid) -> PyTree:
    """``where(valid, new, old)`` per cache leaf, written into ``old`` in
    place: only the valid rows are copied, the others stay bit-for-bit.
    A leaf whose ``new`` is ``old`` itself (updated in place by the
    decoder) is left as it is.  Returns ``old``."""

    def leaf(spec, o, n):
        if n is o:
            return o
        if is_device_mask(valid):
            o.copy_(torch.where(_row_mask(spec, o, valid), n, o))
        else:
            ax = batch_axis(spec)
            rows = valid_rows(valid, o.device)
            o.index_copy_(ax, rows, n.index_select(ax, rows))
        return o

    return map_specs(leaf, specs, old, new)
