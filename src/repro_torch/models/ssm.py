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

Under tensor parallelism (``Runtime.rules`` splitting ``ssm_inner`` and
``ssm_heads`` over ``"model"``) a rank holds contiguous column blocks of
the fused ``w_in`` and of the conv, which do not fall on head edges, and
its heads' per-head vectors, ``norm`` entries and ``w_out`` rows, which
do.  :func:`mamba_block` computes its column block of the projection and
gathers it whole over the axis (``ranks.gather_from``: the backward
reduce-scatters), gathers the small conv weights the same way, then takes
its heads' z, x and dt and its groups' B and C (:func:`rank_dims`),
convolves those channels only and scans its heads.  The gated RMSNorm
over the whole d_inner sums each row's squares over the axis
(``layers.rms_norm_split``, in place of the ``rms_norm`` site) and
``w_out`` is row-parallel.  The decode state of a rank holds its heads'
``ssm_state`` and the conv inputs of its channels
(:func:`ssm_cache_specs` with ``tp``).

Over a sequence split across the ranks (``seq_model``,
``megatron_seq``) the block's input is this rank's rows: it is gathered
whole before the projection (``layers.enter``), so the conv stays causal
over the whole sequence and the scan runs from a zero state, and
``w_out``'s partial sums are reduce-scattered back to the rank's rows
(``layers.row_parallel``).

Under ``ssm_seq`` (Mamba's own form: the block whole on every rank,
``Runtime.seq_rows``) the block runs on this rank's rows and never
gathers them (:func:`_rows_block`): the projections and the gated norm
on the rows, every leaf entering through ``layers.on_rows`` (its
gradient summed over the ranks); the conv reads the previous rank's
last ``d_conv - 1`` inputs (:func:`_halo`); the ``ssd_scan`` site runs
from a zero state on the rows and its final state is handed from rank
to rank (:func:`ssd_rows`: every rank's (B, H, P, N) state and log-decay
gathered, folded in rank order with the reference's operator, the state
entering the rows added to y in float32, as the reference's ``y_off``
term).  ``layers.seq_form`` splits so only where a rank's rows are
whole chunks and hold the conv's halo.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import ranks
from repro_torch.models import layers, masking
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


def rank_dims(cfg: ModelConfig, tp: int) -> Tuple[int, int]:
    """The (heads, groups) a rank holds when the heads split ``tp`` ways:
    its H / tp heads and the groups they read, all H / G heads of a group
    on one rank or one group's heads across ranks (H / tp a multiple of
    H / G, or the reverse); (H, G) for ``tp`` 1.  Other splits raise
    ``ValueError``: a rank's heads would read parts of groups, which the
    scan's head-to-group map cannot give."""
    _, nh, _, _, ng = _dims(cfg)
    if tp == 1:
        return nh, ng
    here, per_group = nh // tp, nh // ng
    if nh % tp or (here % per_group and per_group % here):
        raise ValueError(f"{cfg.name}: {nh} ssm heads in {ng} groups do "
                         f"not split {tp} ways along group edges")
    return here, max(1, here // per_group)


def _rank_channels(cfg: ModelConfig, xbc: torch.Tensor, index: int,
                   tp: int) -> torch.Tensor:
    """Rank ``index`` of ``tp``'s channels of the whole ``[x, B, C]``
    channels (the conv's input, or its weights): its heads' x and its
    groups' B and C, contiguous."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    here, groups = rank_dims(cfg, tp)
    h0, g0 = index * here, index * here * ng // nh
    return torch.cat([xbc[..., h0 * hp:(h0 + here) * hp],
                      xbc[..., d_inner + g0 * dn:
                          d_inner + (g0 + groups) * dn],
                      xbc[..., d_inner + (ng + g0) * dn:
                          d_inner + (ng + g0 + groups) * dn]], dim=-1)


def _rank_proj(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor, axis: ranks.Axis):
    """This rank's ``[z, xBC, dt]`` of the fused projection of ``x`` (as
    the block reads it, ``layers.enter``) and its conv weights and bias,
    from its column blocks of ``w_in`` and of the conv gathered whole
    over ``axis``: its heads' z, x and dt, its groups' B and C."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    here, _ = rank_dims(cfg, axis.size)
    h0 = axis.index * here
    proj = ranks.gather_from(x @ p["w_in"], axis, -1)
    z, xbc, dt = _split_proj(cfg, proj)
    conv_w, conv_b = (_rank_channels(cfg, ranks.gather_from(p[k], axis, -1),
                                     axis.index, axis.size)
                      for k in ("conv_w", "conv_b"))
    return (z[..., h0 * hp:(h0 + here) * hp],
            _rank_channels(cfg, xbc, axis.index, axis.size),
            dt[..., h0:h0 + here], conv_w, conv_b)


def heads_axis(p: Dict[str, torch.Tensor], cfg: ModelConfig,
               rt: Optional[Runtime]) -> Optional[ranks.Axis]:
    """The tensor-parallel axis when ``p`` holds this rank's ssm heads,
    else None."""
    return layers.split_axis(p["a_log"].shape[-1], _dims(cfg)[1], rt,
                             "the ssm heads")


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
    ``torch.matmul``.  Where ``p`` holds this rank's heads, the block
    runs on them as the module's docstring says, and over a split
    sequence x and the output are this rank's rows: gathered around the
    block (``seq_model``, ``megatron_seq``), or under ``ssm_seq``
    (``rt.seq_rows``) the block on the rows with its state handed from
    rank to rank (:func:`_rows_block`)."""
    rt = Runtime() if rt is None else rt
    d_inner, nh, hp, dn, ng = _dims(cfg)
    axis, seq = heads_axis(p, cfg, rt), rt.seq_axis()
    if seq is not None and rt.seq_rows:
        return _rows_block(p, cfg, x, rt, seq)
    x = layers.enter(x, axis, seq)
    bsz, s = x.shape[0], x.shape[1]
    if axis is None:
        here, groups = nh, ng
        z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    else:
        here, groups = rank_dims(cfg, axis.size)
        z, xbc, dt, conv_w, conv_b = _rank_proj(cfg, p, x, axis)
    xbc = _causal_conv(xbc, conv_w, conv_b)
    xs, b, c = torch.split(xbc, [here * hp, groups * dn, groups * dn],
                           dim=-1)
    y, _ = rt.op("ssd_scan")(xs.reshape(bsz, s, here, hp), dt, p["a_log"],
                             b.reshape(bsz, s, groups, dn),
                             c.reshape(bsz, s, groups, dn), p["d_skip"],
                             p["dt_bias"], cfg.ssm.chunk)
    return _gated_out(p, cfg, y.reshape(bsz, s, here * hp), z, rt, axis,
                      seq)


def _rows_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, rt: Runtime, seq: ranks.Axis
                ) -> torch.Tensor:
    """:func:`mamba_block` on this rank's rows of a sequence split over
    ``seq`` with the block whole (``ssm_seq``): the projections, the
    conv, the scan and the gated norm on the rows, every leaf entering
    through ``layers.on_rows``; the conv reads the previous rank's last
    ``d_conv - 1`` inputs (:func:`_halo`) and the scan's state is handed
    from rank to rank (:func:`ssd_rows`)."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    p = {k: layers.on_rows(v, seq) for k, v in p.items()}
    bsz, s = x.shape[0], x.shape[1]
    z, xbc, dt = _split_proj(cfg, x @ p["w_in"])
    window = torch.cat([_halo(xbc, seq, cfg.ssm.conv_width - 1), xbc], 1)
    xbc = _conv_window(window, p["conv_w"], p["conv_b"], s)
    xs, b, c = torch.split(xbc, [d_inner, ng * dn, ng * dn], dim=-1)
    y = ssd_rows(rt.op("ssd_scan"), xs.reshape(bsz, s, nh, hp), dt,
                 p["a_log"], b.reshape(bsz, s, ng, dn),
                 c.reshape(bsz, s, ng, dn), p["d_skip"], p["dt_bias"],
                 cfg.ssm.chunk, seq)[0]
    return _gated_out(p, cfg, y.reshape(bsz, s, d_inner), z, rt, None)


def _halo(xbc: torch.Tensor, seq: ranks.Axis, n: int) -> torch.Tensor:
    """The ``n`` rows of the conv's input before this rank's rows: the
    previous rank's last ``n`` (rank 0 reads zeros, the causal pad).
    Every rank's tail is gathered (``ranks.gather_from``: the backward
    reduce-scatters, each tail's cotangent living on the next rank) and
    every rank reads the gathered tensor, rank 0 its zero pad, so that
    every rank runs the gather's backward."""
    tails = ranks.gather_from(xbc[:, xbc.shape[1] - n:], seq, 1)
    return F.pad(tails, (0, 0, n, 0)).narrow(1, seq.index * n, n)


def ssd_rows(scan, x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor, chunk: int, seq: ranks.Axis
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of a sequence of which this rank holds rows [r S_r,
    (r + 1) S_r), r its index on ``seq``: :func:`ssd_local` on the rows,
    every rank's ``(decay, state)`` pair gathered
    (``ranks.gather_from``: the backward reduce-scatters), then
    :func:`ssd_handoff`.  Shapes as :func:`ssd_chunked`'s; returns (y,
    the whole sequence's final state)."""
    y0, cs, pair = ssd_local(scan, x, dt, a_log, b, c, d_skip, dt_bias,
                             chunk)
    every = ranks.gather_from(pair[None], seq, 0)
    return ssd_handoff(y0, cs, c, every, seq.index)


def ssd_local(scan, x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
              dt_bias: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One rank's part of :func:`ssd_rows` before the handoff: ``scan``
    (the ``ssd_scan`` site) from a zero state on the rows gives y0 and
    the rows' own final state; ``cs`` (B, S_r, H) is the float32
    log-decay ``softplus(dt + dt_bias) (-exp(a_log))`` summed from the
    rank's first row through each row.  Returns (y0, cs, the pair (B, H,
    P N + 1): the state flattened beside the rows' log-decay ``cs[:,
    -1]``)."""
    bsz, _, h, p = x.shape
    n = b.shape[3]
    y0, local = scan(x, dt, a_log, b, c, d_skip, dt_bias, chunk)
    da = F.softplus(compute(dt) + compute(dt_bias)) * \
        -torch.exp(compute(a_log))                              # (B,S,H)
    cs = torch.cumsum(da, dim=1)
    pair = torch.cat([local.to(cs.dtype).reshape(bsz, h, p * n),
                      cs[:, -1, :, None]], dim=-1)
    return y0, cs, pair


def ssd_handoff(y0: torch.Tensor, cs: torch.Tensor, c: torch.Tensor,
                every: torch.Tensor, index: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``index``'s part of :func:`ssd_rows` after the handoff, from
    every rank's pair of :func:`ssd_local` (``every`` (tp, B, H, P N +
    1), in rank order): the pairs ``(exp(L), state)`` folded in rank
    order with the reference's operator ``(dl, sl) . (dr, sr) = (dl dr,
    sr + dr sl)``, the state entering this rank's rows kept, then ``y =
    y0 + exp(cs_t) (C_t . S_in)`` in float32 (the reference's ``y_off``
    term of ``ssd_chunked``), rounded once to y0's dtype.  Every rank
    folds every pair and keeps the state after the earlier ones
    (``torch.where``), so that every rank's y reads the gathered pairs
    (and every rank runs the gather's backward).  Returns (y, the final
    state of the whole sequence)."""
    bsz, _, h, p = y0.shape
    g, n = c.shape[2], c.shape[3]
    state = enter = torch.zeros((bsz, h, p, n), dtype=cs.dtype,
                                device=cs.device)
    for j in range(every.shape[0]):
        decay = torch.exp(every[j, ..., -1])[..., None, None]
        state = every[j, ..., :-1].reshape(bsz, h, p, n) + decay * state
        earlier = torch.tensor(j < index, device=state.device)
        enter = torch.where(earlier, state, enter)
    cheads = compute(c).repeat_interleave(h // g, dim=2)        # (B,S,H,N)
    y_off = torch.einsum("bshn,bhpn->bshp", cheads, enter) * \
        torch.exp(cs)[..., None]
    return (compute(y0) + y_off).to(y0.dtype), state


def _gated_out(p: Dict[str, torch.Tensor], cfg: ModelConfig,
               y: torch.Tensor, z: torch.Tensor, rt: Runtime,
               axis: Optional[ranks.Axis],
               seq: Optional[ranks.Axis] = None) -> torch.Tensor:
    """``norm(y * silu(z)) @ w_out``: the ``rms_norm`` site, or over
    ``axis`` (this rank's heads' columns) the norm of
    ``layers.rms_norm_split``; ``w_out`` through ``layers.row_parallel``
    (``seq``: this rank's rows of the product)."""
    gated = y * F.silu(compute(z)).to(y.dtype)
    if axis is None:
        normed = rt.op("rms_norm")(gated, p["norm"], cfg.norm_eps)
    else:
        normed = layers.rms_norm_split(gated, p["norm"], cfg.norm_eps, axis,
                                       _dims(cfg)[0])
    return layers.row_parallel(normed, p["w_out"], axis, seq)


# ---------------------------------------------------------------------------
# One-token decode
# ---------------------------------------------------------------------------

def ssm_cache_specs(cfg: ModelConfig, batch: int,
                    n_layers: Optional[int] = None,
                    tp: int = 1) -> Dict[str, ParamSpec]:
    """The ssm family's decode state: ``ssm_state`` (L, B, H, P, N)
    float32 and ``conv_state`` (L, B, W-1, conv_dim) in the weights'
    dtype; with the heads split ``tp`` ways, a rank's: its H / tp heads,
    and the conv inputs of their x channels and of their groups' B and
    C (:func:`rank_dims`)."""
    d_inner, nh, hp, dn, ng = _dims(cfg)
    here, groups = rank_dims(cfg, tp)
    nl = n_layers if n_layers is not None else cfg.n_layers
    conv_dim = here * hp + 2 * groups * dn
    return {
        "ssm_state": ParamSpec((nl, batch, here, hp, dn),
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
    result does not depend on which rows are valid.  Where ``p`` holds
    this rank's heads, the states are this rank's
    (:func:`ssm_cache_specs` with ``tp``).  Returns the block's output
    (B, 1, d_model)."""
    rt = Runtime() if rt is None else rt
    d_inner, nh, hp, dn, ng = _dims(cfg)
    bsz = x.shape[0]
    axis = heads_axis(p, cfg, rt)
    if axis is None:
        here, groups = nh, ng
        z, xbc, dt = _split_proj(cfg, (x @ p["w_in"])[:, 0])
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    else:
        here, groups = rank_dims(cfg, axis.size)
        z, xbc, dt, conv_w, conv_b = _rank_proj(
            cfg, p, layers.enter(x[:, 0], axis, None), axis)
    window = torch.cat([conv_state, xbc[:, None].to(conv_state.dtype)],
                       dim=1)                                   # (B, W, C)
    conv_out = _conv_window(window, conv_w, conv_b, 1)[:, 0]
    xs, b, c = torch.split(conv_out.to(x.dtype), [here * hp, groups * dn,
                                                  groups * dn], dim=-1)
    y, new_state = ssd_decode_step(xs.reshape(bsz, here, hp), dt,
                                   p["a_log"], b.reshape(bsz, groups, dn),
                                   c.reshape(bsz, groups, dn), p["d_skip"],
                                   p["dt_bias"], ssm_state)
    masking.write_rows(ssm_state, new_state, rows)
    masking.write_rows(conv_state, window[:, 1:], rows)
    out = _gated_out(p, cfg, y.reshape(bsz, here * hp), z, rt, axis)
    return out[:, None]
