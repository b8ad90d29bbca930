"""Mixture-of-Experts FFN on one device: GShard-style capacity routing.

The port of ``repro.models.moe`` at ``ep_rank = 0, ep_size = 1`` (the
reference's expert-parallel ``shard_map`` path is ROADMAP item 18).
Every token picks its top-k routed experts by a float32 router; each
expert takes at most C tokens (:func:`_capacity`), first choices filling
slots first (k-major cumsum order), and routes over capacity drop.  The
experts run as one batched SwiGLU over their (E, C) slots; the shared
experts, when there are any, run on every token.  Aux loss: Switch
load-balance plus the router z-loss.

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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.precision import compute

EP_ITEM = "ROADMAP.md item 18 (multi-GPU with expert parallelism)"


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


def _moe_ffn(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over x (T, d) -> (y (T, d), aux)."""
    t, d = x.shape
    e_pad = _padded_experts(cfg)
    cap = _capacity(t, cfg)
    idx, weights, aux = route(p, cfg, x)
    tt, wt, vt, slot = _dispatch(idx, weights, e_pad, cap, t)
    xg = x.index_select(0, tt.clamp(0, t - 1).reshape(-1).long())
    xg = xg.reshape(e_pad, cap, d) * vt[..., None].to(x.dtype)
    ye = _expert_ffn(xg, p["w_gate"], p["w_up"], p["w_down"])
    ye = ye * (wt * vt).to(ye.dtype)[..., None]
    rows = torch.cat([ye.reshape(e_pad * cap, d), ye.new_zeros(1, d)])
    y = rows.index_select(0, slot.reshape(-1)).reshape(-1, t, d)
    return y.sum(0), aux


def moe_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, ep_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: routed experts plus the shared experts.  x (B, S, d)
    -> (y (B, S, d), aux scalar).  The tokens of every row route
    together: the capacity is that of B * S tokens."""
    if ep_axis is not None:
        raise NotImplementedError(
            f"{cfg.name}: expert parallelism over {ep_axis!r} is not "
            f"ported; it comes with {EP_ITEM}")
    b, s, d = x.shape
    y, aux = _moe_ffn(p, cfg, x.reshape(b * s, d))
    y = y.reshape(b, s, d)
    if cfg.moe.n_shared:
        sh = p["shared"]
        y = y + layers.swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])
    return y, aux
