"""Grouped-query attention: full sequence (forward / prefill) and
KV-cache decode.

Supports QKV bias (Qwen1.5/Qwen2), qk-norm (Qwen3), GQA with any
n_kv_heads dividing n_heads, and RoPE.  :func:`_sdpa` is the plain
oracle.  :func:`full_attention` runs the attention of a whole sequence
through the ``flash_attention`` kernel site of the :class:`Runtime`, and
:func:`decode_attention` the one-token attention through the
``flash_decode`` site with a per-row ``(B,)`` length.
:func:`cross_attention` (the encoder-decoder's, queries over a memory of
another length) stays the plain :func:`_sdpa`, as the reference leaves
it to XLA, and splits its heads as the self attention does.  The reference's
pure-XLA blocked twin of the flash kernel, ``_sdpa_chunked``, is not
ported: the tests hold the port against the reference's own kernel and
its ``_sdpa``, and the port's kernel site has its plain version.

Under tensor parallelism (``Runtime.rules`` on a mesh whose ``"model"``
axis has more than one rank) ``p`` holds this rank's heads: the local
head counts come from the weights' shapes, the input enters through
``ranks.copy_to`` and the row-parallel ``wo`` leaves through a float32
sum over the axis (``layers.row_parallel``).  Where the kv heads do not
split over the axis but the q heads do, they stay whole and each rank
reads the one kv head of its q heads (:func:`kv_heads_here`); the
cache of a rank then holds that head.

Over a sequence that ``Runtime.seq_axis()`` splits (``seq_model``,
``megatron_seq``) the input is this rank's rows: it enters through
``layers.enter`` (gathered whole over the axis), q, k and v are
projected and rotated over the whole sequence, and ``wo``'s float32
partial sums are reduce-scattered back to the rank's rows
(``layers.row_parallel``).  Under ``ssm_seq`` the heads are whole: the
input is gathered whole, every rank attends over the whole sequence
with all heads and keeps its rows of the output (``split_to``); the
weights, applied to the gathered sequence, take no ``copy_to``.  The
cross attention reads the memory whole.  A decode step never splits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import ranks
from repro_torch.models import layers, masking
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute, compute_dtype

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": ParamSpec((d, nh, hd), ("fsdp_embed", "heads", "head_dim")),
        "wk": ParamSpec((d, nkv, hd), ("fsdp_embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, nkv, hd), ("fsdp_embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((nh, hd, d), ("heads", "head_dim", "fsdp_embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((nh, hd), ("heads", "head_dim"),
                                init="zeros")
        specs["bk"] = ParamSpec((nkv, hd), ("kv_heads", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((nkv, hd), ("kv_heads", "head_dim"),
                                init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return specs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def kv_heads_here(cfg: ModelConfig, n_q: int) -> int:
    """The kv heads a rank holding ``n_q`` of the q heads reads: all of
    them unsplit; its share when they split over the ranks as the q
    heads do; one when they stay whole while the q heads split (the q
    heads of a rank then share one kv head)."""
    if n_q == cfg.n_heads:
        return cfg.n_kv_heads
    ways = cfg.n_heads // n_q
    if cfg.n_kv_heads % ways == 0:
        return cfg.n_kv_heads // ways
    if ways % cfg.n_kv_heads == 0:
        return 1
    raise ValueError(f"{cfg.name}: {cfg.n_kv_heads} kv heads neither split "
                     f"over {ways} ranks nor serve whole groups of their "
                     f"{n_q} q heads")


def kv_heads_split(cfg: ModelConfig, tp: int) -> int:
    """The kv heads of a rank's cache under tensor parallelism over
    ``tp`` ranks: those its q heads read (:func:`kv_heads_here`), the q
    heads split where they divide ``tp`` and whole elsewhere, as
    ``layers.spec_to_pspec`` lays them out."""
    n_q = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
    return kv_heads_here(cfg, n_q)


def tp_axis(p: Dict[str, torch.Tensor], cfg: ModelConfig,
            rt: Runtime) -> Optional[ranks.Axis]:
    """The tensor-parallel axis when ``p`` holds this rank's heads, else
    None."""
    return layers.split_axis(p["wq"].shape[-2], cfg.n_heads, rt,
                             "the attention's heads")


def _kv_params(p: Dict[str, torch.Tensor], cfg: ModelConfig,
               axis: Optional[ranks.Axis]) -> Dict[str, torch.Tensor]:
    """The k/v weights (and biases) this rank reads: ``p``'s own, or
    where the kv heads stay whole while the q heads split, the one kv
    head of this rank's q heads, entering through ``copy_to`` (every
    rank's gradient of the whole leaf is the sum of the ranks' parts)."""
    keys = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
    if axis is None or p["wk"].shape[-2] != cfg.n_kv_heads:
        return {k: p[k] for k in keys}
    n_q = p["wq"].shape[-2]
    first = axis.index * n_q // (cfg.n_heads // cfg.n_kv_heads)
    n = kv_heads_here(cfg, n_q)
    return {k: ranks.copy_to(p[k], axis).narrow(-2, first, n) for k in keys}


def _project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, rt: Runtime, rope,
                 axis: Optional[ranks.Axis] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, D) with bias, qk-norm and RoPE applied, of ``x``
    as the attention reads it (``layers.enter``); ``rope`` is the ``(cos,
    sin)`` of the tokens' positions
    (:func:`repro_torch.models.layers.rope_cos_sin`).  With ``axis``
    (:func:`tp_axis`) H counts this rank's heads, and the whole per-head
    leaves enter through ``copy_to``."""
    kv = _kv_params(p, cfg, axis)
    q = _heads(x, p["wq"])
    k = _heads(x, kv["wk"])
    v = _heads(x, kv["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    if cfg.qk_norm:
        norm = rt.op("rms_norm")
        q_norm, k_norm = p["q_norm"], p["k_norm"]
        if axis is not None:
            q_norm, k_norm = (ranks.copy_to(q_norm, axis),
                              ranks.copy_to(k_norm, axis))
        q = norm(q, q_norm, cfg.norm_eps)
        k = norm(k, k_norm, cfg.norm_eps)
    cos, sin = rope
    return layers.rotate(q, cos, sin), layers.rotate(k, cos, sin), v


def _out(p: Dict[str, torch.Tensor], out: torch.Tensor,
         axis: Optional[ranks.Axis],
         seq: Optional[ranks.Axis] = None) -> torch.Tensor:
    """The attention output (B, S, H, D) through ``wo`` -> (B, S, d),
    summed over ``axis`` when H is this rank's heads, this rank's rows
    of it over a split sequence (``layers.row_parallel``)."""
    b, s, h, d = out.shape
    return layers.row_parallel(out.reshape(b, s, h * d),
                               p["wo"].reshape(h * d, -1), axis, seq)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset=None, kv_len=None) -> torch.Tensor:
    """Reference scaled-dot-product GQA attention (the plain oracle).

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  Hq % Hkv == 0.
    q_offset: absolute position of q[.., 0] — scalar or per-batch (B,).
    kv_len: number of valid kv positions — scalar or (B,).
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    scores = compute(torch.einsum("bshgd,bthd->bhgst", qg, k))
    scores = scores / math.sqrt(d)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[None, :]
        if q_offset is not None:
            off = torch.as_tensor(q_offset, device=q.device)
            off = off[:, None] if off.dim() == 1 else off.reshape(1, 1)
            qpos = qpos + off
        mask = mask & (kpos[None, None, :] <= qpos[..., None])
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device)
        kl = kl[:, None, None] if kl.dim() == 1 else kl.reshape(1, 1, 1)
        mask = mask & (kpos[None, None, :] < kl)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


# ---------------------------------------------------------------------------
# Full-sequence attention
# ---------------------------------------------------------------------------

def full_attention_kv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, causal: bool = True,
                      rt: Optional[Runtime] = None, rope=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`full_attention` that also returns the sequence's k and v
    (B, S, Hkv, D), k rotated — what a prefill writes to the cache."""
    rt = Runtime() if rt is None else rt
    axis, seq = tp_axis(p, cfg, rt), rt.seq_axis()
    x = layers.enter(x, axis, seq)
    if rope is None:
        rope = layers.rope_cos_sin(
            torch.arange(x.shape[1], device=x.device)[None], cfg.head_dim_,
            cfg.rope_theta, compute_dtype(x.dtype))
    q, k, v = _project_qkv(p, cfg, x, rt, rope, axis)
    out = rt.op("flash_attention")(q, k, v, causal)
    return _out(p, out, axis, seq), k, v


def full_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                   x: torch.Tensor, causal: bool = True,
                   rt: Optional[Runtime] = None, rope=None) -> torch.Tensor:
    """Self-attention over a full sequence (forward / prefill).  x (B, S,
    d) at positions 0..S-1 -> (B, S, d), this rank's rows of both over a
    split sequence; the inner attention runs through the
    ``flash_attention`` site.  ``rope`` is the whole sequence's ``(cos,
    sin)`` when the caller has it (the decoder computes it once for all
    layers)."""
    return full_attention_kv(p, cfg, x, causal, rt, rope)[0]


def cross_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, memory: torch.Tensor,
                    rope, rt: Optional[Runtime] = None) -> torch.Tensor:
    """Encoder-decoder cross attention: x (B, S, d) over ``memory`` (B,
    S_mem, d), no mask.  q is rotated by ``rope``, the ``(cos, sin)`` of
    positions 0..S-1; k and v are not rotated.  Returns (B, S, d).  With
    this rank's heads in ``p`` (:func:`tp_axis`), its q heads read its
    kv heads of the memory, x and the memory entering through
    ``copy_to``, and ``wo`` is row-parallel.  Over a split sequence x
    is this rank's rows of the decoder's stream (``layers.enter``), the
    memory whole and ``rope`` the whole sequence's."""
    axis = tp_axis(p, cfg, rt)
    seq = None if rt is None else rt.seq_axis()
    kv = _kv_params(p, cfg, axis)
    x = layers.enter(x, axis, seq)
    if axis is not None:
        memory = ranks.copy_to(memory, axis)
    q = _heads(x, p["wq"])
    k = _heads(memory, kv["wk"])
    v = _heads(memory, kv["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    q = layers.rotate(q, *rope)
    return _out(p, _sdpa(q, k, v, causal=False), axis, seq)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                   n_layers: Optional[int] = None,
                   kv_heads: Optional[int] = None) -> Dict[str, ParamSpec]:
    """The k and v caches, (L, B, S_max, Hkv, D) each; ``kv_heads`` is a
    rank's count under tensor parallelism (:func:`kv_heads_here`)."""
    nl = n_layers if n_layers is not None else cfg.n_layers
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    shape = (nl, batch, max_len, hkv, cfg.head_dim_)
    axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shape, axes), "v": ParamSpec(shape, axes)}


def decode_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, position: torch.Tensor,
                     rt: Optional[Runtime] = None,
                     rows: Optional[torch.Tensor] = None, rope=None
                     ) -> torch.Tensor:
    """One-token attention against a cache, updating it IN PLACE.

    x: (B, 1, d); k_cache/v_cache: (B, S_max, Hkv, D); position: (B,)
    int — the index each row's token writes (its cache is valid in
    [0, position]).  The new K/V rows are written at
    ``(row, position[row])`` for the rows in ``rows``: a 1-D index
    tensor, or a ``(B,)`` bool device mask (every row is then written as
    ``where(rows, new, old)``, with no host read); ``None`` means every
    row.  The other rows of the cache are left bit-unchanged.  Then the attention runs through the
    flash-decode site with ``kv_len = position + 1``.  ``rope`` is the
    positions' ``(cos, sin)`` when the caller has it (the decoder computes
    it once per step for all layers).  Returns the attention output
    (B, 1, d)."""
    rt = Runtime() if rt is None else rt
    b = x.shape[0]
    position = position.to(torch.int32)
    if rope is None:
        rope = layers.rope_cos_sin(position[:, None], cfg.head_dim_,
                                   cfg.rope_theta)
    axis = tp_axis(p, cfg, rt)
    q, k, v = _project_qkv(p, cfg, layers.enter(x, axis, None), rt, rope,
                           axis)
    if masking.is_device_mask(rows):
        every = torch.arange(b, device=x.device)
        at = position.long()
        keep = rows[:, None, None]
        k_cache[every, at] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                         k_cache[every, at])
        v_cache[every, at] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                         v_cache[every, at])
    else:
        if rows is None:
            rows = torch.arange(b, device=x.device)
        at = position[rows].long()
        k_cache[rows, at] = k[rows, 0].to(k_cache.dtype)
        v_cache[rows, at] = v[rows, 0].to(v_cache.dtype)
    out = rt.op("flash_decode")(q[:, 0], k_cache, v_cache, position + 1)
    return _out(p, out[:, None], axis)
