"""Mamba2 — SSD (state-space duality) blocks, full-sequence forward.

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): within a chunk
the output is computed in quadratic attention-like form; across chunks a
linear recurrence carries the (H, P, N) state.  :func:`ssd_chunked` is
the plain version (the SSD kernel's oracle), :func:`ssd_decode_step` the
exact single-token recurrence (the definitional oracle of both), and
:func:`mamba_block` the full block, whose scan goes through the
``ssd_scan`` kernel site of the :class:`Runtime` and whose gated norm
through ``rms_norm``.

One-token decode: :func:`ssm_cache_specs` declares the decode state (a
float32 ``ssm_state`` and a ``conv_state`` of the last W-1 conv inputs a
layer), and :func:`mamba_decode_block` advances it by one token, writing
both states in place at the valid rows (as
:func:`repro_torch.models.attention.decode_attention` writes K/V), so a
masked step never copies the state.  Its recurrence is plain PyTorch, as
the reference computes it outside any kernel; its gated norm goes
through ``rms_norm``.

Layout follows the reference: d_inner = expand * d_model, H = d_inner /
head_dim heads, scalar decay A per head, B/C shared across heads in
``n_groups`` groups.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import masking
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.d_state, s.n_groups


def ssm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    s = cfg.ssm
    d_inner, nh, hp, dn, ng = _dims(cfg)
    conv_dim = d_inner + 2 * ng * dn
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": ParamSpec((d, 2 * d_inner + 2 * ng * dn + nh),
                          ("fsdp_embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="ones",
                           dtype=torch.float32),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros",
                             dtype=torch.float32),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones",
                            dtype=torch.float32),
        "norm": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((d_inner, d), ("ssm_inner", "fsdp_embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """``[z, xBC, dt]`` views of the fused input projection."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * ng * dn, nh], dim=-1)


def _conv_window(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 s: int) -> torch.Tensor:
    """``sum_i window[:, i:i+s] * w[i] + b`` over a (B, S + W - 1, C)
    window with kernel (W, C), then SiLU in float32: the conv of
    :func:`_causal_conv` and of one decode step, in one summation
    order."""
    out = window[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        out = out + window[:, i:i + s] * w[i]
    return F.silu(compute(out + b)).to(window.dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C), then SiLU
    in float32."""
    pad = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    return _conv_window(pad, w, b, xbc.shape[1])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """exp-stable segment sum: out[..., i, j] = sum_{j<k<=i} x[..., k]
    (-inf above the diagonal)."""
    t = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                dt_bias: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, in float32.

    x: (B, S, H, P)  dt: (B, S, H)  b,c: (B, S, G, N)
    a_log/dt_bias/d_skip: (H,).  Returns (y (B,S,H,P) in x's dtype,
    final_state (B,H,P,N) float32).  The chunks' states are chained by a
    loop over the chunks (the reference uses an associative scan; the
    recurrence is the same)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence "
                         f"length {s}")
    nc = s // chunk
    rep = h // g

    dt = F.softplus(compute(dt) + compute(dt_bias))             # (B,S,H)
    a = -torch.exp(compute(a_log))                              # (H,)
    da = dt * a
    xdt = compute(x) * dt[..., None]                            # x_t dt

    xc = xdt.reshape(bsz, nc, chunk, h, p)                      # (B,nc,L,H,P)
    bheads = compute(b).reshape(bsz, nc, chunk, g, n) \
        .repeat_interleave(rep, dim=3)                          # (B,nc,L,H,N)
    cheads = compute(c).reshape(bsz, nc, chunk, g, n) \
        .repeat_interleave(rep, dim=3)
    dac = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)    # (B,H,nc,L)
    da_cs = torch.cumsum(dac, dim=-1)

    # ---- intra-chunk (quadratic, attention-like) ----
    lmat = torch.exp(_segsum(dac))                              # (B,H,nc,L,L)
    scores = torch.einsum("bclhn,bcshn->bhcls", cheads, bheads)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores * lmat, xc)

    # ---- chunk-final states ----
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)           # (B,H,nc,L)
    states = torch.einsum("bclhn,bclhp->bchpn", bheads,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # ---- inter-chunk linear recurrence ----
    chunk_decay = torch.exp(da_cs[..., -1]).permute(0, 2, 1)    # (B,nc,H)
    state = (torch.zeros((bsz, h, p, n), dtype=xdt.dtype, device=x.device)
             if init_state is None else init_state.to(xdt.dtype))
    prev = []
    for ci in range(nc):
        prev.append(state)              # the state entering chunk ci
        state = chunk_decay[:, ci, :, None, None] * state + states[:, ci]
    prev = torch.stack(prev, dim=1)                             # (B,nc,H,P,N)

    # ---- chunk-state contribution to outputs ----
    state_decay = torch.exp(da_cs).permute(0, 2, 3, 1)          # (B,nc,L,H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cheads, prev) * \
        state_decay[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + compute(d_skip)[None, None, :, None] * compute(x)
    return y.to(x.dtype), state


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    dt_bias: torch.Tensor, state: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact single-token recurrence.

    x: (B, H, P); dt: (B, H); b,c: (B, G, N); state: (B, H, P, N) float32.
    Returns (y (B, H, P) in x's dtype, new state)."""
    h = x.shape[1]
    rep = h // b.shape[1]
    dt = F.softplus(compute(dt) + compute(dt_bias))
    a = -torch.exp(compute(a_log))
    decay = torch.exp(dt * a)                                   # (B,H)
    bh = compute(b).repeat_interleave(rep, dim=1)               # (B,H,N)
    ch = compute(c).repeat_interleave(rep, dim=1)
    xf = compute(x)
    new_state = decay[..., None, None] * state + \
        (dt[..., None] * xf)[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    y = y + compute(d_skip)[None, :, None] * xf
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def mamba_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, rt: Optional[Runtime] = None
                ) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B, S, d_model) -> same shape.
    The scan runs through the ``ssd_scan`` site (from a zero state) and
    the gated norm through ``rms_norm``; the projections stay
    ``torch.matmul``."""
    rt = Runtime() if rt is None else rt
    d_inner, nh, hp, dn, ng = _dims(cfg)
    bsz, s = x.shape[0], x.shape[1]
    z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, b, c = torch.split(xbc, [d_inner, ng * dn, ng * dn], dim=-1)
    y, _ = rt.op("ssd_scan")(xs.reshape(bsz, s, nh, hp), dt, p["a_log"],
                             b.reshape(bsz, s, ng, dn),
                             c.reshape(bsz, s, ng, dn), p["d_skip"],
                             p["dt_bias"], cfg.ssm.chunk)
    y = y.reshape(bsz, s, d_inner)
    gated = y * F.silu(compute(z)).to(y.dtype)
    return rt.op("rms_norm")(gated, p["norm"], cfg.norm_eps) @ p["w_out"]


# ---------------------------------------------------------------------------
# One-token decode
# ---------------------------------------------------------------------------

def ssm_cache_specs(cfg: ModelConfig, batch: int,
                    n_layers: Optional[int] = None) -> Dict[str, ParamSpec]:
    """The ssm family's decode state: ``ssm_state`` (L, B, H, P, N)
    float32 and ``conv_state`` (L, B, W-1, conv_dim) in the weights'
    dtype."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    nl = n_layers if n_layers is not None else cfg.n_layers
    conv_dim = d_inner + 2 * ng * dn
    return {
        "ssm_state": ParamSpec((nl, batch, nh, hp, dn),
                               ("layers", "batch", "ssm_heads",
                                "head_dim", "ssm_state"),
                               dtype=torch.float32),
        "conv_state": ParamSpec((nl, batch, cfg.ssm.conv_width - 1,
                                 conv_dim),
                                ("layers", "batch", None, "ssm_inner")),
    }


def mamba_decode_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                       x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor,
                       rt: Optional[Runtime] = None, rows=None
                       ) -> torch.Tensor:
    """One-token Mamba2 step.  x: (B, 1, d_model); ssm_state (B, H, P,
    N) float32 and conv_state (B, W-1, conv_dim), both updated IN PLACE
    at ``rows`` (:func:`repro_torch.models.masking.valid_rows`: index
    rows, a ``(B,)`` bool device mask, or ``None`` for every row); the
    other rows stay bit-unchanged.  Every row is computed, so a row's
    result does not depend on which rows are valid.  Returns the block's
    output (B, 1, d_model)."""
    rt = Runtime() if rt is None else rt
    d_inner, nh, hp, dn, ng = _dims(cfg)
    bsz = x.shape[0]
    z, xbc, dt = _split_proj(cfg, (x @ p["w_in"])[:, 0])
    window = torch.cat([conv_state, xbc[:, None].to(conv_state.dtype)],
                       dim=1)                                   # (B, W, C)
    conv_out = _conv_window(window, p["conv_w"], p["conv_b"], 1)[:, 0]
    xs, b, c = torch.split(conv_out.to(x.dtype), [d_inner, ng * dn,
                                                  ng * dn], dim=-1)
    y, new_state = ssd_decode_step(xs.reshape(bsz, nh, hp), dt, p["a_log"],
                                   b.reshape(bsz, ng, dn),
                                   c.reshape(bsz, ng, dn), p["d_skip"],
                                   p["dt_bias"], ssm_state)
    masking.write_rows(ssm_state, new_state, rows)
    masking.write_rows(conv_state, window[:, 1:], rows)
    gated = y.reshape(bsz, d_inner) * F.silu(compute(z)).to(y.dtype)
    out = rt.op("rms_norm")(gated, p["norm"], cfg.norm_eps) @ p["w_out"]
    return out[:, None]
