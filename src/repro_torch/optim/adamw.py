"""AdamW with float32 master weights, cosine schedule and global-norm clip.

The port of ``repro.optim.adamw``, with its arithmetic: the state per
parameter is a float32 master copy plus float32 first and second
moments, the step counter an int32 scalar; every update clips the
gradients to ``clip_norm`` by their global norm, applies decoupled
weight decay, and casts every new parameter to ``param_dtype`` (float32
specs included, as the reference does).  The schedule, the step and the
bias corrections are float32 scalar tensors on the parameters' device,
so a train step reads nothing back to the host.  ``abstract_state``
gives the state's ``meta`` stand-ins for the dry-run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_util

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``min_lr_frac * peak_lr`` at ``decay_steps``; float32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: PyTree) -> Dict[str, Any]:
    """{step: int32 0, master: float32 copy, m: zeros, v: zeros}."""
    leaf = tree_util.leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "master": tree_util.map(lambda p: p.detach().to(torch.float32,
                                                        copy=True), params),
        "m": tree_util.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
        "v": tree_util.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params),
    }


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for g in tree_util.leaves(tree):
        part = torch.sum(torch.square(g.to(torch.float32)))
        total = part if total is None else total + part
    return torch.sqrt(total)


def update(cfg: OptConfig, grads: PyTree, state: Dict[str, Any],
           param_dtype: torch.dtype = torch.bfloat16, *,
           params: PyTree = None, grad_norm: torch.Tensor = None
           ) -> Tuple[PyTree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params (cast to ``param_dtype``), new_state, metrics
    {grad_norm, lr}).

    Given ``params`` (the current parameter tree, of ``param_dtype``),
    the update runs in place — the port's counterpart of the reference
    Trainer donating its parameter and optimizer buffers to the step: the
    moments and the master weights are overwritten, the new parameters
    are written into ``params`` (a leaf of another dtype is replaced),
    and the returned trees hold those same tensors.  The arithmetic is the same either way, one rounding per
    operation in the reference's order.  Without ``params`` nothing is
    overwritten.  ``grad_norm``, when given, is the global norm to clip
    by, for gradients of which this process holds a part (a rank's
    experts)."""
    inplace = params is not None
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        if inplace:
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        else:
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        del g
        step_ = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        step_.add_(cfg.weight_decay * p).mul_(lr)
        p = p.sub_(step_) if inplace else p - step_
        return m, v, p

    like = state["master"]
    new_m, new_v, new_master = [], [], []
    for g, m, v, p in zip(tree_util.leaves(grads),
                          tree_util.leaves(state["m"]),
                          tree_util.leaves(state["v"]),
                          tree_util.leaves(like)):
        m, v, p = upd(g, m, v, p)
        new_m.append(m)
        new_v.append(v)
        new_master.append(p)
    if inplace:
        # a leaf of another dtype (a float32 spec under bf16 training) is
        # replaced, as the reference's cast replaces it
        new_params = tree_util.map(
            lambda old, new: old.copy_(new) if old.dtype == param_dtype
            else new.to(param_dtype), params,
            tree_util.unflatten(like, new_master))
    else:
        new_params = tree_util.unflatten(
            like, [p.to(param_dtype) for p in new_master])
    new_state = {"step": step,
                 "master": tree_util.unflatten(like, new_master),
                 "m": tree_util.unflatten(like, new_m),
                 "v": tree_util.unflatten(like, new_v)}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def abstract_state(abstract_params: PyTree) -> Dict[str, Any]:
    """The optimizer state of ``abstract_params`` as ``meta`` tensors
    (the dry-run's stand-ins): int32 ``step``, float32 ``master``, ``m``
    and ``v`` of every parameter's shape."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "master": tree_util.map(f32, abstract_params),
        "m": tree_util.map(f32, abstract_params),
        "v": tree_util.map(f32, abstract_params),
    }
