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

With ``rt.mesh`` of more than one rank the workers are real ranks, and
each rank passes its own rows of the global batch.  Four paths, as the
reference takes them on its production meshes:

* **The Spindle modes** (:func:`rank_grads`, the reference's
  ``_manual_grads``): each rank takes the gradient of its own loss with
  no expert parallelism (the reference's ``rt_inner`` has no mesh, so
  every rank holds every expert, also on a mesh with a ``"model"``
  axis, where ranks that differ only there compute the same thing).
  The loss is ``all_reduce(loss) / n`` over the data axes ``rt.dp_axes``
  (one axis, or their product such as ``("pod", "data")``) and the
  gradients are reduced there by the rank form of ``rt.gradsync``; the
  compressed mode runs its int8 leg over the last data axis and then a
  plain mean over each earlier one, as the reference does across pods.
* **gspmd without split experts**: the same, with one ``all_reduce``
  mean a leaf: the reduction a framework's data parallelism inserts,
  which is what the reference's GSPMD partitioning emits for replicated
  parameters (its numbers are those of ``spindle_per_tensor``).
* **gspmd with the experts split** over ``rt.ep_axis``
  (:func:`ep_rank_grads`; the reference's ``_ffn`` under GSPMD): each
  rank takes the gradient of its own loss on its data shard (its rows
  over ``("pod", "data")``, the same on every rank of the expert axis)
  with its own experts (:mod:`repro_torch.models.moe`).  The non-expert
  leaves' gradients are then the same on every rank of the expert axis;
  every leaf is reduced by a per-tensor mean over the data axes only,
  the expert leaves never over the expert axis, and the global norm
  that AdamW clips by adds the expert leaves' squares over it.  The
  reported loss is the reference's: the cross-entropy mean over every
  data shard plus the aux loss of data shard 0 (its ``shard_map`` hands
  back shard 0's aux), while the gradient is that of the cross-entropy
  mean plus the mean of the shards' aux losses.
* **gspmd with the rules' layout** (:func:`layout_rank_grads`; the
  reference's GSPMD step on parameters placed by ``tree_shardings``):
  ``rt.rules`` split any family's leaves (``registry.layout``), each
  rank holding its blocks (``layers.shard_params``).  The rows are
  split over :data:`TOKEN_AXES` as for the experts; the ranks of
  ``"model"`` compute on their heads (attention and ssm), MLP columns,
  expert rows and vocabulary rows (tensor and expert parallelism), and
  a layer's ``"data"`` blocks are gathered before use, their gradient
  reduce-scattered (FSDP).  An MoE reports the loss of the split
  experts' path.  A leaf's
  gradient is then summed over the data axes its blocks do not lie on
  and divided by the data ranks, which gives the mean; a block is never
  reduced over ``"model"``.  The loss is the mean over the data axes,
  and the global norm adds each split leaf's squares over the axes that
  split it (:func:`sharded_global_norm`).  Under ``seq_model``,
  ``megatron_seq`` and ``ssm_seq`` the ranks of ``"model"`` also split
  the sequence (``layers.seq_form``); a whole leaf applied on a rank's
  rows (each norm scale; under ``ssm_seq`` the Mamba blocks' and the
  SwiGLUs' weights too) enters through ``ranks.copy_to`` at its site, so
  its gradient is already whole on every rank here.

Every rank then applies the same AdamW step to what it holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core import gradsync, ranks
from repro_torch.models import layers, moe, registry, transformer
from repro_torch.models.registry import Arch
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw

PyTree = Any
BUCKET_BYTES = 32 << 20
# the axes an expert-parallel layer's tokens are split over (the
# reference's ``tok_spec`` in ``transformer._ffn``)
TOKEN_AXES = ("pod", "data")


def value_and_grad(arch: Arch, rt: Runtime,
                   loss_fn: Optional[Callable] = None) -> Callable:
    """``fn(params, batch) -> (loss, grads)``: the loss (detached) and
    its gradient with respect to every parameter leaf, in the leaves'
    dtypes, for every family (the MoE's loss includes its aux term).  The
    parameters are not modified.  ``loss_fn`` replaces the arch's."""
    cfg = arch.cfg
    loss_fn = arch.loss_fn() if loss_fn is None else loss_fn

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


def reduce_grads(grads: PyTree, rt: Runtime,
                 bucket_bytes: int = BUCKET_BYTES,
                 axis: Optional[ranks.Axis] = None) -> PyTree:
    """The mean of the gradients by ``rt.gradsync``'s Spindle mode (fused
    buckets, per tensor, or compressed): of stacked ``(W, ...)`` folded
    workers' gradients, or with ``axis`` of this rank's over the axis.
    ``gspmd`` on ranks is the per-tensor mean (see the module's
    docstring).  Over a product of axes of ``rt.mesh`` the compressed
    mode's int8 leg runs over the last of them, then a plain mean over
    each earlier one."""
    if rt.gradsync == "spindle_per_tensor" or (rt.gradsync == "gspmd"
                                               and axis is not None):
        return gradsync.per_tensor_psum_mean(grads, axis)
    one = grads if axis is not None else tree_util.map(lambda g: g[0], grads)
    plan = gradsync.make_plan(one, target_bytes=bucket_bytes)
    if rt.gradsync == "spindle_compressed":
        outer = ()
        if axis is not None and isinstance(axis.name, tuple):
            *outer, last = axis.name
            axis = rt.mesh.axis(last)
        mean, _ = gradsync.compressed_psum_mean(grads, plan, None, rt, axis)
        for name in outer:            # a plain mean across the pods
            mean = gradsync.per_tensor_psum_mean(mean, rt.mesh.axis(name))
        return mean
    if rt.gradsync == "spindle":
        return gradsync.fused_psum_mean(grads, plan, axis)
    raise ValueError(f"{rt.gradsync!r} is not a Spindle reduction mode")


def dp_axis(rt: Runtime) -> ranks.Axis:
    """The mesh axis the gradients reduce over: ``rt.dp_axes``, one axis
    of ``rt.mesh`` or the product of several."""
    return rt.mesh.axis(rt.dp_axes)


def splits_experts(arch: Arch, rt: Runtime) -> bool:
    """Whether the train step runs the MoE's experts split over
    ``rt.ep_axis``: ``gspmd`` on a mesh that gives that axis more than
    one rank.  The Spindle modes never do (the reference's manual region
    runs without its mesh)."""
    return (arch.cfg.moe is not None and rt.gradsync == "gspmd"
            and rt.moe_ep_size() > 1)


def splits_layout(arch: Arch, rt: Runtime) -> bool:
    """Whether the train step runs on the rules' layout: ``gspmd`` with
    ``rt.rules`` splitting a non-expert leaf or the sequence on
    ``rt.mesh`` (``registry.layout``, which refuses what waits).  The Spindle modes
    never do (the reference's manual region runs without its rules)."""
    return rt.gradsync == "gspmd" and \
        registry.layout(arch.cfg, rt) is not None


def batch_axis(arch: Arch, rt: Runtime) -> Optional[ranks.Axis]:
    """The mesh axis whose index picks this rank's rows of a global batch:
    :data:`TOKEN_AXES` present in the mesh when the step splits the
    experts or runs on the rules' layout (None when there are none),
    else :func:`dp_axis`."""
    if splits_experts(arch, rt) or splits_layout(arch, rt):
        names = tuple(a for a in TOKEN_AXES if a in rt.mesh.shape)
        return rt.mesh.axis(names) if names else None
    return dp_axis(rt)


def rank_grads(arch: Arch, rt: Runtime,
               bucket_bytes: int = BUCKET_BYTES) -> Callable:
    """``fn(params, batch) -> (loss, grads)`` on one rank of ``rt.mesh``:
    the gradient of this rank's loss on its batch (its rows of the global
    batch), then the mean loss and the mean gradients over the data axes
    by ``rt.gradsync`` (the reference's ``_manual_grads``).  The loss
    inside runs without the mesh, as the reference's manual region
    does."""
    vg = value_and_grad(arch, dataclasses.replace(rt, mesh=None,
                                                  rules=None))
    axis = dp_axis(rt)

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        loss, grads = vg(params, batch)
        loss = ranks.all_reduce(loss, axis) / axis.size
        return loss, reduce_grads(grads, rt, bucket_bytes, axis)

    return fn


def sharded_global_norm(grads: PyTree,
                        split_over: Dict[str, ranks.Axis]) -> torch.Tensor:
    """:func:`repro_torch.optim.adamw.global_norm` of the whole gradient
    when this rank holds a block of some leaves: ``split_over`` maps a
    leaf's path to the axis (one, or a product) its blocks lie over, and
    that leaf's squares are summed over it (one ``all_reduce`` an axis,
    in the order the leaves first name them); every leaf's part is added
    in leaf order as the unsplit norm adds them."""
    parts, groups = [], {}
    for path, g in tree_util.paths(grads):
        parts.append(torch.sum(torch.square(g.to(torch.float32))))
        axis = split_over.get(path)
        if axis is not None:
            groups.setdefault(axis.name, (axis, []))[1].append(
                len(parts) - 1)
    for axis, where in groups.values():
        summed = ranks.all_reduce(torch.stack([parts[i] for i in where]),
                                  axis)
        for i, total in zip(where, summed.unbind()):
            parts[i] = total
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return torch.sqrt(out)


def _split_experts_loss(data: Optional[ranks.Axis]) -> Callable:
    """The MoE's loss where its experts split: the cross entropy plus
    the aux loss whose value is data shard 0's (what the reference's
    ``shard_map`` hands back) and whose gradient is this rank's own."""
    def loss_fn(params, cfg, batch, rt):
        ce, aux = transformer.lm_loss_terms(params, cfg, batch, rt)
        return ce + (aux if data is None else ranks.from_first(aux, data))
    return loss_fn


def _data_shards(arch: Arch, rt: Runtime) -> Optional[ranks.Axis]:
    """:func:`batch_axis` where it holds more than one rank, else None."""
    data = batch_axis(arch, rt)
    return None if data is None or data.size == 1 else data


def ep_rank_grads(arch: Arch, rt: Runtime) -> Callable:
    """``fn(params, batch) -> (loss, grads, grad_norm)`` on one rank of a
    mesh whose ``rt.ep_axis`` splits the experts (``params`` holds this
    rank's, :func:`repro_torch.models.moe.shard_experts`): the gradient
    of this rank's loss on its data shard, reduced by a per-tensor mean
    over the data axes (:func:`batch_axis`), never over the expert axis;
    the reported loss and the global norm as the module's docstring
    says."""
    cfg = arch.cfg
    if cfg.family != "moe":
        raise ValueError(f"{cfg.name}: experts split over ranks train in "
                         f"the moe family only, not {cfg.family}")
    data = _data_shards(arch, rt)
    experts = rt.mesh.axis(rt.ep_axis)
    vg = value_and_grad(arch, rt, _split_experts_loss(data))

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        loss, grads = vg(params, batch)
        if data is not None:
            loss = ranks.all_reduce(loss, data) / data.size
            grads = gradsync.per_tensor_psum_mean(grads, data)
        return loss, grads, sharded_global_norm(
            grads, {path: experts for path, _ in tree_util.paths(grads)
                    if moe.is_expert_leaf(path)})

    return fn


def _in_mesh_order(rt: Runtime, names) -> Tuple[str, ...]:
    return tuple(a for a in rt.mesh.shape if a in names)


def layout_rank_grads(arch: Arch, rt: Runtime) -> Callable:
    """``fn(params, batch) -> (loss, grads, grad_norm)`` on one rank of a
    mesh whose rules lay out the parameters (``params`` holds this rank's
    blocks, ``layers.shard_params``): the gradient of this rank's loss
    on its data shard, each leaf summed over the data axes its blocks do
    not lie on (an FSDP block's gradient is already summed over its own,
    by the gather's reduce-scatter) and divided by the data ranks; the
    loss the mean over the data axes; the global norm as the module's
    docstring says."""
    layout = registry.layout(arch.cfg, rt)
    data = _data_shards(arch, rt)
    names = () if data is None else layers.entry_axes(data.name)
    over, split_over = {}, {}
    for path, part in layout.items():
        axes = [a for entry in part for a in layers.entry_axes(entry)]
        fsdp = [a for a in axes if a != layers.TP_AXIS]
        if any(a not in names for a in fsdp):
            raise ValueError(f"{path}: its blocks over {fsdp} are not "
                             f"among the data axes {names}")
        rest = _in_mesh_order(rt, [a for a in names if a not in fsdp])
        over[path] = rt.mesh.axis(rest) if rest else None
        if axes:
            split_over[path] = rt.mesh.axis(_in_mesh_order(rt, axes))
    vg = value_and_grad(arch, rt, _split_experts_loss(data)
                        if splits_experts(arch, rt) else None)

    def fn(params: PyTree, batch: Dict[str, torch.Tensor]):
        loss, grads = vg(params, batch)
        if data is not None:
            loss = ranks.all_reduce(loss, data) / data.size
            mean = []
            for path, g in tree_util.paths(grads):
                if over[path] is not None:
                    g = ranks.all_reduce(g, over[path])
                mean.append(g / data.size)
            grads = tree_util.unflatten(grads, mean)
        return loss, grads, sharded_global_norm(grads, split_over)

    return fn


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
    are then spent.  On ``rt.mesh`` of more than one rank every rank
    calls the step on its own batch (the module's docstring says which of
    four paths it takes); where the experts are split or the rules lay
    out the parameters, on its own blocks and their AdamW state."""
    vg = value_and_grad(arch, rt)
    per_worker = worker_grads(arch, rt)
    per_rank = split = None
    if splits_layout(arch, rt):
        split = layout_rank_grads(arch, rt)
    elif splits_experts(arch, rt):
        split = ep_rank_grads(arch, rt)
    elif rt.ranks > 1:
        per_rank = rank_grads(arch, rt, bucket_bytes)

    def train_step(params: PyTree, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[PyTree, Dict[str, Any], Dict[str, Any]]:
        norm = None
        if split is not None:
            loss, grads, norm = split(params, batch)
        elif per_rank is not None:
            loss, grads = per_rank(params, batch)
        elif rt.gradsync.startswith("spindle") and rt.spmd:
            losses, stacked = per_worker(params, batch)
            loss = losses.sum() / rt.dp_workers
            grads = reduce_grads(stacked, rt, bucket_bytes)
            del stacked
        else:
            loss, grads = vg(params, batch)
        new_params, new_opt, metrics = adamw.update(
            opt_cfg, grads, opt_state, param_dtype,
            params=params if donate else None, grad_norm=norm)
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
