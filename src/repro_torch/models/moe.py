"""Mixture-of-Experts FFN: GShard-style capacity routing, on one device or
with its experts split over ranks.

The port of ``repro.models.moe``.  Every token picks its top-k routed
experts by a float32 router; each expert takes at most C tokens
(:func:`_capacity`), first choices filling slots first (k-major cumsum
order), and routes over capacity drop.  The experts run as one batched
SwiGLU over their (E, C) slots; the shared experts, when there are any,
run on every token.  Aux loss: Switch load-balance plus the router
z-loss.

Everything is static in shape and never reads the device from the host,
so a decode step that routes can be captured in a CUDA graph
(:mod:`repro_torch.serve.fused`):

* the reference's dropping scatter (``.at[...].set(mode="drop")``)
  becomes a scatter into (E+1, C+1) tables whose last row and column
  take every dropped route, sliced away;
* the reference's combine, a scatter-add of the slots' outputs into the
  tokens, becomes a gather: each token reads its K slots through a
  (K, T) slot map (a dropped route reads a zero row) and sums them in k
  order.  The sum is the same; it needs no atomics, so a bf16 output is
  the same from run to run.

The pad experts (``ep_pad_to`` > ``n_routed``: qwen2-moe-a2.7b's 60
experts in 64 slots) never route: the router has ``n_routed`` columns.
They run on zero rows, as in the reference, and add nothing.

Expert parallelism (the reference's ``shard_map`` over ``ep_axis``,
``_moe_ffn_sharded``): on a :class:`~repro_torch.core.ranks.RankMesh`
whose ``ep_axis`` has ``ep`` ranks, rank ``i`` holds experts ``[i E/ep,
(i + 1) E/ep)`` (:func:`shard_experts`) and the same tokens as its peers.
It routes every token and builds the global tables, runs its experts'
rows of them, combines their outputs (a route to another rank's expert
reads the zero row) in float32 and sums that partial output over the
axis, rounding the sum once to the input's dtype; then the shared
experts are added.  A token's k experts are summed in k order on each
rank and the ranks' sums then added, so the result differs from the
unsplit one (one float32 sum in k order, rounded once) by the float32
summation order only.

A gradient runs through the split experts as the reference's ``psum``
transposes inside ``shard_map``: the partial output's sum is
:func:`~repro_torch.core.ranks.reduce_from` (its backward hands every
rank the whole cotangent), and what enters the rank's own experts --
the tokens, in float32, and the routing weights -- is
:func:`~repro_torch.core.ranks.copy_to` (its backward sums the ranks'
parts).  The router then gets its whole gradient on every rank: the
combine weights' part summed over the ranks, the aux loss's computed
whole from the full router probabilities on each.  The expert leaves'
gradients stay per rank, each rank's rows only.

Over a sequence split across the ranks (``seq_model``,
``megatron_seq``, ``ssm_seq``: the input is this rank's rows) the router
and the routed experts read the rows gathered whole
(``ranks.gather_whole``, as the reference's ``tok_spec`` gathers the
sequence, so the capacity is the whole sequence's), the experts' float32
partial output is reduce-scattered back to the rank's rows, and the
shared experts run as a split SwiGLU between their own gather and
reduce-scatter, or under ``ssm_seq`` whole on the rank's rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core import ranks
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.precision import compute

# the leaves split over the expert axis (the reference's ``expert_specs``:
# the router and the shared experts are replicated)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _padded_experts(cfg: ModelConfig) -> int:
    m = cfg.moe
    return m.ep_pad_to if m.ep_pad_to else m.n_routed


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    e = _padded_experts(cfg)
    specs = {
        "router": ParamSpec((d, m.n_routed), ("embed", None),
                            dtype=torch.float32),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared:
        specs["shared"] = layers.mlp_specs(d, m.n_shared * f)
    return specs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert: ``max(8, ceil(ceil(T K cf / E) / 8) 8)`` with E
    the padded expert count."""
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor
                  / _padded_experts(cfg))
    return max(8, math.ceil(c / 8) * 8)


def router_logits(p: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> torch.Tensor:
    """x (T, d) -> (T, n_routed) router logits, a float32 product whatever
    the router's dtype, as the reference's promotion of
    ``x.astype(float32) @ router`` gives: an update casts the float32
    router to bf16, so from the second train step on it arrives in
    bf16."""
    return compute(x) @ compute(p["router"])


def route(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: top-k experts a token with normalised weights.

    x (T, d) -> (idx (T, K) int64, weights (T, K) float32, aux scalar),
    the logits from :func:`router_logits`.  Equal probabilities rank the
    lower expert first, as ``jax.lax.top_k`` does (a stable descending
    sort).  The aux term is differentiable through the mean router
    probability and the z-loss; the first-choice fractions carry no
    gradient, as in the reference."""
    m = cfg.moe
    logits = router_logits(p, x)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :m.top_k], idx[:, :m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    e = m.n_routed
    experts = torch.arange(e, device=x.device)
    frac = (idx[:, :1] == experts).to(probs.dtype).mean(0)
    aux = m.aux_coef * e * (frac * probs.mean(0)).sum()
    z = m.router_z_coef * torch.logsumexp(logits, dim=-1).square().mean()
    return idx, weights, aux + z


def _dispatch(idx: torch.Tensor, weights: torch.Tensor, n_experts: int,
              capacity: int, n_tokens: int):
    """:func:`dispatch_tables` and the (K, T) slot map of every route:
    ``e * C + c`` for a kept route in slot c of expert e, ``E * C`` for a
    dropped one."""
    t, k = idx.shape
    dev = idx.device
    # routes in k-major order (first choices fill slots first), one-hot
    # as (E, K*T): the running count scans the innermost dim, which on
    # CUDA is a fast scan (an outer-dim scan of (K*T, E) took half of a
    # full-width MoE forward's device time)
    expert = idx.T.reshape(-1)                                  # (K*T,)
    flat = (torch.arange(n_experts, device=dev)[:, None] == expert
            ).to(torch.int32)
    pos = ((torch.cumsum(flat, dim=1, dtype=torch.int32) - 1)
           * flat).sum(0)                                       # (K*T,)
    keep = pos < capacity
    token = torch.arange(t, device=dev, dtype=torch.int32).repeat(k)
    slot_e = torch.where(keep, expert, n_experts)
    slot_c = torch.where(keep, pos, capacity)
    cell = slot_e * (capacity + 1) + slot_c          # dropped: the last cell
    cells = (n_experts + 1, capacity + 1)
    token_table = torch.full(cells, n_tokens, dtype=torch.int32, device=dev)
    token_table.view(-1).scatter_(0, cell, token)
    weight_table = torch.zeros(cells, dtype=weights.dtype, device=dev)
    weight_table.view(-1).scatter_(0, cell, weights.T.reshape(-1))
    token_table = token_table[:n_experts, :capacity]
    weight_table = weight_table[:n_experts, :capacity]
    slot = torch.where(keep, expert * capacity + pos,
                       n_experts * capacity).reshape(k, t)
    return token_table, weight_table, token_table < n_tokens, slot


def dispatch_tables(idx: torch.Tensor, weights: torch.Tensor,
                    n_experts: int, capacity: int, n_tokens: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity dispatch: the (E, C) token-index (int32), weight (the
    weights' dtype, float32) and valid tables.  First-choice routes take
    priority (k-major cumsum order); routes over capacity drop.  An
    invalid slot holds token index ``n_tokens``."""
    return _dispatch(idx, weights, n_experts, capacity, n_tokens)[:3]


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) through each expert's SwiGLU: batched products, silu
    in float32."""
    g = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    h = torch.nn.functional.silu(compute(g)).to(xe.dtype) * u
    return torch.bmm(h, wd)


def _moe_ffn(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
             ep: Optional[ranks.Axis] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over x (T, d) -> (y (T, d), aux); with ``ep``
    this rank's experts' part of y."""
    t, d = x.shape
    e_pad = _padded_experts(cfg)
    e_local = p["w_gate"].shape[0]
    if e_local * (1 if ep is None else ep.size) != e_pad:
        raise ValueError(f"{cfg.name}: {e_local} experts here, "
                         f"{e_pad} over {1 if ep is None else ep.size} "
                         "ranks")
    cap = _capacity(t, cfg)
    idx, weights, aux = route(p, cfg, x)
    if ep is not None:
        # what enters this rank's experts; the aux term stays whole
        weights = ranks.copy_to(weights, ep)
        x = ranks.copy_to(compute(x), ep).to(x.dtype)
    tt, wt, vt, slot = _dispatch(idx, weights, e_pad, cap, t)
    if ep is not None:
        lo = ep.index * e_local
        tt, wt, vt = (a[lo:lo + e_local] for a in (tt, wt, vt))
        # a route to another rank's expert reads the zero row
        slot = slot - lo * cap
        slot = torch.where((slot >= 0) & (slot < e_local * cap), slot,
                           e_local * cap)
    xg = x.index_select(0, tt.clamp(0, t - 1).reshape(-1).long())
    xg = xg.reshape(e_local, cap, d) * vt[..., None].to(x.dtype)
    ye = _expert_ffn(xg, p["w_gate"], p["w_up"], p["w_down"])
    ye = ye * (wt * vt).to(ye.dtype)[..., None]
    rows = torch.cat([ye.reshape(e_local * cap, d), ye.new_zeros(1, d)])
    y = rows.index_select(0, slot.reshape(-1)).reshape(-1, t, d)
    if ep is None:
        return y.sum(0), aux
    # a rank's part stays float32: moe_block adds the parts, then rounds
    return y.sum(0, dtype=torch.float32), aux


def moe_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, ep_axis: Optional[str] = None,
              mesh: Optional[ranks.RankMesh] = None,
              shared_axis: Optional[ranks.Axis] = None,
              seq: Optional[ranks.Axis] = None, rows: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: routed experts plus the shared experts.  x (B, S, d)
    -> (y (B, S, d), aux scalar).  The tokens of every row route
    together: the capacity is that of B * S tokens.  With ``ep_axis``,
    an axis of ``mesh``, ``p`` holds this rank's experts
    (:func:`shard_experts`), every rank of the axis passes the same x,
    and each gets the whole y; a gradient through it is each rank's part
    (see the module's docstring).  With ``shared_axis`` the shared
    experts are this rank's columns and rows of their SwiGLU (tensor
    parallelism, ``layers.swiglu``).  With ``seq`` x and y are this
    rank's rows of the sequence (see the module's docstring); with
    ``rows`` too (``ssm_seq``) the whole shared experts run on them
    (``layers.swiglu``'s ``rows``)."""
    ep = None
    if ep_axis is not None:
        if mesh is None:
            raise ValueError(f"ep_axis={ep_axis!r} names an axis of a "
                             "RankMesh; pass mesh=")
        ep = mesh.axis(ep_axis)
    every = x if seq is None else ranks.gather_whole(x, seq, 1)
    b, s, d = every.shape
    y, aux = _moe_ffn(p, cfg, every.reshape(b * s, d), ep)
    y = y.reshape(b, s, d)
    if ep is not None and seq is not None and ep.name == seq.name:
        y = ranks.reduce_scatter_to(y, seq, 1).to(x.dtype)
    else:
        if ep is not None:
            y = ranks.reduce_from(y, ep).to(x.dtype)
        if seq is not None:
            y = ranks.split_to(y, seq, 1)
    if cfg.moe.n_shared:
        sh = p["shared"]
        y = y + layers.swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                              shared_axis, seq, rows)
    return y, aux


def is_expert_leaf(path: str) -> bool:
    """Whether the ``/``-joined ``path`` of a parameter tree (or of a tree
    that nests one, as the AdamW state and a checkpoint do) names an
    MoE layer's expert leaf, split over the expert axis."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and \
        parts[-1] in EXPERT_LEAVES


def _expert_dim(leaf: torch.Tensor) -> int:
    """The expert dim of an expert leaf, stacked ``(L, E, ...)`` or one
    layer's ``(E, ...)``."""
    return leaf.dim() - 3


def shard_experts(params: Any, index: int, size: int) -> Any:
    """Rank ``index`` of ``size``'s part of a parameter tree: every MoE
    layer's expert leaves (:func:`is_expert_leaf`) cut to experts
    ``[index E/size, (index + 1) E/size)`` on their expert dim, as
    contiguous copies (so that the full leaves can be freed); every other
    leaf, the router and the shared experts included, is the same
    tensor.  Any tree that nests parameter trees (the AdamW state, a
    checkpoint's) is cut the same way."""
    def cut(path: str, leaf):
        if not is_expert_leaf(path):
            return leaf
        dim = _expert_dim(leaf)
        e = leaf.shape[dim]
        if e % size:
            raise ValueError(f"{path}: {e} experts do not split over "
                             f"{size} ranks")
        n = e // size
        return leaf.narrow(dim, index * n, n).contiguous()

    return tree_util.unflatten(params, [cut(path, leaf) for path, leaf
                                        in tree_util.paths(params)])


def gather_experts(tree: Any, axis: ranks.Axis) -> Any:
    """The inverse of :func:`shard_experts` across ranks: every expert
    leaf gathered over ``axis`` (every rank of the axis calls this) and
    its parts joined in axis order on the expert dim; every other leaf
    is the same tensor."""
    def join(path: str, leaf):
        if not is_expert_leaf(path):
            return leaf
        parts = ranks.all_gather(leaf, axis)
        return torch.cat(torch.unbind(parts), dim=_expert_dim(leaf))

    return tree_util.unflatten(tree, [join(path, leaf) for path, leaf
                                      in tree_util.paths(tree)])


def whole_like(tree: Any, size: int) -> Any:
    """Empty tensors of the whole tree's shapes, from a rank's part of it
    cut ``size`` ways (a template to restore a checkpoint into)."""
    def grow(path: str, leaf):
        shape = list(leaf.shape)
        if is_expert_leaf(path):
            shape[_expert_dim(leaf)] *= size
        return torch.empty(shape, dtype=leaf.dtype, device=leaf.device)

    return tree_util.unflatten(tree, [grow(path, leaf) for path, leaf
                                      in tree_util.paths(tree)])
