"""The step factories: the train step (loss + gradients + Spindle gradient
sync + AdamW) and the serving steps (prefill / decode).

The port of ``repro.train.steps``.  Gradient-reduction modes
(``rt.gradsync``), as in the reference:

  gspmd               the framework owns the reduction: the gradient of
                      the whole batch's loss (on one device, no
                      reduction at all).
  spindle             fused buckets: every ready bucket coalesced into
                      one reduction (opportunistic batching).
  spindle_per_tensor  one reduction per tensor (the unbatched strawman).
  spindle_compressed  fused buckets with the int8 all-gather leg
                      (:func:`repro_torch.core.gradsync.
                      compressed_psum_mean`, through the ``quantize`` and
                      ``dequantize`` kernel sites).

The reference takes the Spindle path when its mesh has more than one
device, computing each data-parallel worker's gradient inside
``shard_map`` and reducing across the mesh.  The port folds the
``rt.dp_workers`` = W workers onto one device: worker ``w`` takes rows
``[w*B/W, (w+1)*B/W)`` of every batch leaf (the reference's ``_dp_spec``),
its loss and gradients are computed one worker after another, the
gradients are stacked ``(W, ...)`` and reduced by the mode.  The loss is
the mean of the workers' losses.  With W = 1, or with ``gspmd``, the step
takes the gradient of the whole batch, as the reference does on one
device.  The compressed mode starts every step from zero error-feedback
residuals and drops the new ones, as the reference's train step does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core import gradsync
from repro_torch.models.registry import Arch
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw

PyTree = Any
BUCKET_BYTES = 32 << 20


def value_and_grad(arch: Arch, rt: Runtime) -> Callable:
    """``fn(params, batch) -> (loss, grads)``: the loss (detached) and
    its gradient with respect to every parameter leaf, in the leaves'
    dtypes, for every family (the MoE's loss includes its aux term).  The
    parameters are not modified."""
    cfg = arch.cfg
    loss_fn = arch.loss_fn()

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        leaves = [p.detach().requires_grad_() for p in
                  tree_util.leaves(params)]
        loss = loss_fn(tree_util.unflatten(params, leaves), cfg, batch, rt)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_util.unflatten(params, list(grads))

    return fn


def worker_grads(arch: Arch, rt: Runtime) -> Callable:
    """``fn(params, batch) -> (losses (W,), stacked grads)``: each of the
    ``rt.dp_workers`` workers' loss and gradients on its rows of every
    batch leaf (tokens, and the vlm's patches or the encdec's frames),
    the gradients stacked along a leading worker dim (each leaf
    ``(W, *shape)``).  A worker's forward sees only its rows, so an MoE
    layer's capacity comes from the worker's own (B/W) S tokens, as
    inside the reference's ``shard_map``."""
    vg = value_and_grad(arch, rt)
    w_count = rt.dp_workers

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        rows = {k: v.shape[0] for k, v in batch.items()}
        if any(r % w_count for r in rows.values()):
            raise ValueError(f"batch rows {rows} do not split over "
                             f"{w_count} data-parallel workers")
        parts = {k: v.tensor_split(w_count) for k, v in batch.items()}
        stacked, losses = None, []
        for w in range(w_count):
            loss, grads = vg(params, {k: p[w] for k, p in parts.items()})
            if stacked is None:
                stacked = tree_util.map(
                    lambda g: torch.empty((w_count, *g.shape), dtype=g.dtype,
                                          device=g.device), grads)
            for dst, g in zip(tree_util.leaves(stacked),
                              tree_util.leaves(grads)):
                dst[w].copy_(g)
            del grads
            losses.append(loss)
        return torch.stack(losses), stacked

    return fn


def reduce_grads(stacked: PyTree, rt: Runtime,
                 bucket_bytes: int = BUCKET_BYTES) -> PyTree:
    """The mean of stacked ``(W, ...)`` gradients by ``rt.gradsync``'s
    Spindle mode (fused buckets, per tensor, or compressed)."""
    if rt.gradsync == "spindle_per_tensor":
        return gradsync.per_tensor_psum_mean(stacked)
    plan = gradsync.make_plan(tree_util.map(lambda g: g[0], stacked),
                              target_bytes=bucket_bytes)
    if rt.gradsync == "spindle_compressed":
        mean, _ = gradsync.compressed_psum_mean(stacked, plan, None, rt)
        return mean
    if rt.gradsync == "spindle":
        return gradsync.fused_psum_mean(stacked, plan)
    raise ValueError(f"{rt.gradsync!r} is not a Spindle reduction mode")


def make_train_step(arch: Arch, rt: Runtime,
                    opt_cfg: adamw.OptConfig = adamw.OptConfig(), *,
                    bucket_bytes: int = BUCKET_BYTES,
                    param_dtype: torch.dtype = torch.bfloat16,
                    donate: bool = False) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``grad_norm`` and ``lr`` (float32 scalars on
    the device).  The new parameters are cast to ``param_dtype`` (the
    reference's ``adamw.update`` default, bfloat16).  ``donate=True``
    updates the parameters and the optimizer state in place, as the
    reference's Trainer donates them to its jitted step; the arguments
    are then spent."""
    vg = value_and_grad(arch, rt)
    per_worker = worker_grads(arch, rt)

    def train_step(params: PyTree, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[PyTree, Dict[str, Any], Dict[str, Any]]:
        if rt.gradsync.startswith("spindle") and rt.spmd:
            losses, stacked = per_worker(params, batch)
            loss = losses.sum() / rt.dp_workers
            grads = reduce_grads(stacked, rt, bucket_bytes)
            del stacked
        else:
            loss, grads = vg(params, batch)
        new_params, new_opt, metrics = adamw.update(
            opt_cfg, grads, opt_state, param_dtype,
            params=params if donate else None)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_serve_step(arch: Arch, rt: Runtime, kind: str) -> Callable:
    """``"prefill"`` -> ``step(params, batch)``; ``"decode"`` ->
    ``step(params, cache, batch, position)``, for every family: the vlm's
    prefill takes ``batch["patches"]`` too, the encdec's is its encoder
    (``batch["frames"]`` -> ``(memory, {})``), the recurrent families'
    their forward."""
    cfg = arch.cfg
    if kind == "prefill":
        fn = arch.prefill_fn()
        if fn is not None:
            return lambda params, batch: fn(params, batch, rt)
        # recurrent families: prefill == the chunked full forward; run the
        # loss forward (the same compute) over the batch
        loss_fn = arch.loss_fn()
        return lambda params, batch: loss_fn(params, cfg, batch, rt)
    if kind == "decode":
        decode = arch.decode_fn()

        def serve_step(params, cache, batch, position):
            return decode(params, cfg, cache, batch["tokens"], position, rt)

        return serve_step
    raise KeyError(kind)
