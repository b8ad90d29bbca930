"""Zamba2-style hybrid: a backbone of Mamba2 blocks with ONE shared
attention+MLP transformer block invoked periodically (weight reuse).

Structure (arXiv:2411.15242, simplified as the reference does):
``n_layers`` Mamba2 blocks; after every ``attn_every``-th block the
shared transformer block runs, with the same parameters at each
invocation.  The original concatenates the embedding output with the
hidden state at the shared block's inputs and applies per-invocation
LoRAs; the reference keeps the shared block and its periodic schedule
only, and so does the port.

Layout, as in the reference: the Mamba layers are stacked ``(G,
attn_every, ...)`` (``mamba_layers``), G = n_layers / attn_every
super-blocks each ending in the shared block (``shared_block``); the
decode state is a float32 ``ssm_state`` and a ``conv_state`` per Mamba
layer, ``(G, attn_every, B, ...)``, beside one K/V cache per invocation
group, ``(G, B, S_max, Hkv, D)``.

Every entry point walks the stack's norm sites in order (:func:`_walk`):
the first is ``rms_norm`` and each later ``x = x + y; h = norm(x)`` is one
fused ``rms_norm_residual``, as in the dense decoder.  The Mamba blocks
run through :func:`repro_torch.models.ssm.mamba_block` (forward; the
``ssd_scan`` site) or :func:`~repro_torch.models.ssm.mamba_decode_block`
(decode), the shared block's attention through ``flash_attention``
(forward) or ``flash_decode`` (decode).  For zamba2-2.7b (54 layers,
attn_every 6) that is 55 ``rms_norm`` (the first norm and 54 gated
norms) and 72 ``rms_norm_residual`` calls a forward or a step, with 54
``ssd_scan`` and 9 ``flash_attention`` calls a forward or 9
``flash_decode`` calls a step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute_dtype

PyTree = Any
# a norm site: its scale and what runs on the normed input
Site = Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    k = cfg.hybrid.attn_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: attn_every {k} does not divide "
                         f"n_layers {cfg.n_layers}")
    return cfg.n_layers // k, k


def hybrid_specs(cfg: ModelConfig) -> Dict[str, Any]:
    g, k = _groups(cfg)
    mamba = {"norm": layers.norm_specs(cfg.d_model),
             "ssm": ssm.ssm_specs(cfg)}
    shared = {
        "attn_norm": layers.norm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg),
        "ffn_norm": layers.norm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "fsdp_embed")),
        "mamba_layers": layers.map_specs(
            lambda s: s.stack_layers(k).stack_layers(g), mamba),
        "shared_block": shared,
        "final_norm": layers.norm_specs(cfg.d_model),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("fsdp_embed", "vocab")),
    }


def unstack_groups(stacked: PyTree) -> List[List[PyTree]]:
    """The ``(G, attn_every, ...)`` Mamba layers as ``[g][i]`` per-layer
    trees of views (:func:`repro_torch.models.transformer.
    unstack_layers` on both leading dims)."""
    return [transformer.unstack_layers(group)
            for group in transformer.unstack_layers(stacked)]


def _shared_block(p: Dict[str, Any], attn: Callable) -> List[Site]:
    """The shared block's two norm sites: ``attn(h)`` after the attention
    norm, the SwiGLU MLP after the FFN norm."""
    m = p["mlp"]
    return [(p["attn_norm"]["scale"], attn),
            (p["ffn_norm"]["scale"],
             lambda h: layers.swiglu(h, m["w_gate"], m["w_up"],
                                     m["w_down"]))]


def _walk(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
          mamba: Callable, attn: Callable
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack over the embedded x.  ``mamba(p, h, g, i)`` runs Mamba
    layer ``[g][i]`` and ``attn(h, g)`` the shared block's attention in
    group ``g``.  Returns ``(x, y)``: the residual stream and the last
    site's output, not yet added (the final norm adds it as it
    normalises)."""
    shared = params["shared_block"]
    sites: List[Site] = []
    for g, group in enumerate(unstack_groups(params["mamba_layers"])):
        sites += [(lp["norm"]["scale"],
                   lambda h, p=lp["ssm"], g=g, i=i: mamba(p, h, g, i))
                  for i, lp in enumerate(group)]
        sites += _shared_block(shared, lambda h, g=g: attn(h, g))
    eps = cfg.norm_eps
    y = None
    for scale, fn in sites:
        if y is None:
            h = rt.op("rms_norm")(x, scale, eps)
        else:
            h, x = rt.op("rms_norm_residual")(y, x, scale, eps)
        y = fn(h)
    return x, y


def _final_norm(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                y: torch.Tensor, rt: Runtime) -> torch.Tensor:
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return h


def _stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_walk` over a full sequence of embedded x (B, S, d),
    positions 0..S-1."""
    positions = torch.arange(x.shape[1], device=x.device)[None]
    rope = layers.rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta,
                               compute_dtype(x.dtype))
    attn_p = params["shared_block"]["attn"]
    return _walk(params, cfg, x, rt,
                 lambda p, h, g, i: ssm.mamba_block(p, cfg, h, rt),
                 lambda h, g: attention.full_attention(attn_p, cfg, h, True,
                                                       rt, rope))


def forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
            rt: Runtime) -> torch.Tensor:
    """The hybrid stack on embedded inputs x (B, S, d) -> the hidden
    states (B, S, d) before the final norm, as the reference returns
    them."""
    x, y = _stack(params, cfg, x, rt)
    return x + y


def hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
           rt: Runtime) -> torch.Tensor:
    """The full-sequence stack over ``tokens`` (B, S) -> the final-normed
    hidden states (B, S, d)."""
    x, y = _stack(params, cfg, transformer.embed(params, cfg, tokens), rt)
    return _final_norm(params, cfg, x, y, rt)


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
            rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy (with the z-loss) over ``batch["tokens"]``
    (B, S); ``batch["mask"]`` marks the valid target positions.  Returns
    a float32 scalar."""
    tokens = batch["tokens"]
    logits = hidden(params, cfg, tokens, rt)[:, :-1] @ params["lm_head"]
    mask = batch.get("mask")
    return layers.cross_entropy_loss(
        logits, tokens[:, 1:], None if mask is None else mask[:, 1:])


# ---------------------------------------------------------------------------
# Decode: SSM states for every Mamba layer + ONE KV cache for the shared
# block per invocation group (the shared block attends at G points).
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, ParamSpec]:
    g, k = _groups(cfg)
    ssm_specs = ssm.ssm_cache_specs(cfg, batch, n_layers=k)
    kv = attention.kv_cache_specs(cfg, batch, max_len, n_layers=g)
    return {**layers.map_specs(lambda s: s.stack_layers(g), ssm_specs),
            **kv}


def decode_step(params: PyTree, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, position: torch.Tensor, rt: Runtime,
                valid=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) int; position: (B,) int — each
    row's write index in the shared block's K/V caches; cache
    {ssm_state, conv_state: (G, attn_every, B, ...), k, v: (G, B, S_max,
    Hkv, D)}, updated IN PLACE at the rows where ``valid`` holds (every
    row for ``None``; host rows or a device mask, see
    :mod:`repro_torch.models.masking`).  Returns ``(logits (B, V),
    cache)`` — the same cache dict."""
    position = position.to(torch.int32)
    rows = valid_rows(valid, position.device)
    # the rotation in the forward's precision (float64 for float64)
    rope = layers.rope_cos_sin(position[:, None], cfg.head_dim_,
                               cfg.rope_theta,
                               compute_dtype(params["embed"].dtype))
    attn_p = params["shared_block"]["attn"]
    x, y = _walk(params, cfg, transformer.embed(params, cfg, tokens), rt,
                 lambda p, h, g, i: ssm.mamba_decode_block(
                     p, cfg, h, cache["ssm_state"][g, i],
                     cache["conv_state"][g, i], rt, rows),
                 lambda h, g: attention.decode_attention(
                     attn_p, cfg, h, cache["k"][g], cache["v"][g], position,
                     rt, rows, rope))
    h = _final_norm(params, cfg, x, y, rt)
    return (h @ params["lm_head"])[:, 0], cache
