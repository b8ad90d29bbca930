"""The plain reference of the training step: the dense decoder's loss
(``reference.qwen3.row_loss``, token mean over the batch) and its
gradient in float32, the gradient clipped to a global norm, and AdamW
with decoupled weight decay on float32 master weights, the weights the
forward reads being the master rounded to the dtype the configuration
states for its weights.  The learning rate warms up linearly to its peak."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import qwen3


def paths(tree: Dict, prefix: str = ""):
    """(dotted path, leaf) of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from paths(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _unflatten(names: List[str], leaves: List[torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, leaf in zip(names, leaves):
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def run(params0: Dict, config: Dict, opt: Dict, batches, quant=None
        ) -> Dict:
    """Steps over ``batches`` ((B, S) token tensors) from ``params0``:
    each step's loss, each leaf's first gradient norm (as the optimizer
    takes it, after the clip) and each leaf's change after the last
    step."""
    names = [n for n, _ in paths(params0)]
    dtype = params0["embed"].dtype
    master = [p.detach().float() for _, p in paths(params0)]
    start = [p.clone() for p in master]
    m = [torch.zeros_like(p) for p in master]
    v = [torch.zeros_like(p) for p in master]
    losses, first = [], None
    for step, tokens in enumerate(batches, start=1):
        leaves = [p.to(dtype, copy=True).float().requires_grad_()
                  for p in master]
        tree = _unflatten(names, leaves)
        grads = [torch.zeros_like(p) for p in master]
        count = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for row in tokens:
            loss = qwen3.row_loss(tree, config, row, opt["z_coef"],
                                  quant) / count
            for g, d in zip(grads, torch.autograd.grad(loss, leaves)):
                g.add_(d)
            total += float(loss.detach())
            del loss
        losses.append(total)
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads))
        scale = min(opt["clip_norm"] / max(norm, 1e-9), 1.0)
        lr = opt["peak_lr"] * step / opt["warmup_steps"]
        b1c, b2c = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
        for g, mm, vv, p in zip(grads, m, v, master):
            g.mul_(scale)
            mm.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
            vv.mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
            upd = (mm / b1c) / ((vv / b2c).sqrt() + opt["eps"])
            p.sub_(lr * (upd + opt["weight_decay"] * p))
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(names, grads)}
        del grads, leaves, tree
    change = {n: float((p - s).norm())
              for n, p, s in zip(names, master, start)}
    return {"loss": losses, "grad": first, "change": change}
