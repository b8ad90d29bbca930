"""Grouped-query attention: full sequence (forward / prefill) and
KV-cache decode.

Supports QKV bias (Qwen1.5/Qwen2), qk-norm (Qwen3), GQA with any
n_kv_heads dividing n_heads, and RoPE.  :func:`_sdpa` is the plain
oracle.  :func:`full_attention` runs the attention of a whole sequence
through the ``flash_attention`` kernel site of the :class:`Runtime`, and
:func:`decode_attention` the one-token attention through the
``flash_decode`` site with a per-row ``(B,)`` length.  The reference's
pure-XLA blocked twin of the flash kernel, ``_sdpa_chunked``, is not
ported: the tests hold the port against the reference's own kernel and
its ``_sdpa``, and the port's kernel site has its plain version.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers
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


def _project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, rt: Runtime, rope
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, D) with bias, qk-norm and RoPE applied;
    ``rope`` is the ``(cos, sin)`` of the tokens' positions
    (:func:`repro_torch.models.layers.rope_cos_sin`)."""
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        norm = rt.op("rms_norm")
        q = norm(q, p["q_norm"], cfg.norm_eps)
        k = norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope
    return layers.rotate(q, cos, sin), layers.rotate(k, cos, sin), v


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
    b, s, _ = x.shape
    if rope is None:
        rope = layers.rope_cos_sin(torch.arange(s, device=x.device)[None],
                                   cfg.head_dim_, cfg.rope_theta,
                                   compute_dtype(x.dtype))
    q, k, v = _project_qkv(p, cfg, x, rt, rope)
    out = rt.op("flash_attention")(q, k, v, causal)
    hq, hd = cfg.n_heads, cfg.head_dim_
    return out.reshape(b, s, hq * hd) @ p["wo"].reshape(hq * hd, -1), k, v


def full_attention(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                   x: torch.Tensor, causal: bool = True,
                   rt: Optional[Runtime] = None, rope=None) -> torch.Tensor:
    """Self-attention over a full sequence (forward / prefill).  x (B, S,
    d) at positions 0..S-1 -> (B, S, d); the inner attention runs through
    the ``flash_attention`` site.  ``rope`` is the positions' ``(cos,
    sin)`` when the caller has it (the decoder computes it once for all
    layers)."""
    return full_attention_kv(p, cfg, x, causal, rt, rope)[0]


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def kv_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                   n_layers: Optional[int] = None) -> Dict[str, ParamSpec]:
    nl = n_layers if n_layers is not None else cfg.n_layers
    shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
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
    ``(row, position[row])`` for the rows in ``rows`` (a 1-D index
    tensor; ``None`` means every row); the other rows of the cache are
    left bit-unchanged.  Then the attention runs through the
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
    q, k, v = _project_qkv(p, cfg, x, rt, rope)
    if rows is None:
        rows = torch.arange(b, device=x.device)
    at = position[rows].long()
    k_cache[rows, at] = k[rows, 0].to(k_cache.dtype)
    v_cache[rows, at] = v[rows, 0].to(v_cache.dtype)
    out = rt.op("flash_decode")(q[:, 0], k_cache, v_cache, position + 1)
    hq, hd = cfg.n_heads, cfg.head_dim_
    return (out.reshape(b, 1, hq * hd) @ p["wo"].reshape(hq * hd, -1))
