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
``flash_decode`` calls a step.  On the full sequence each group's sites
(the reference's super block: its Mamba layers and the shared block)
are one region of ``rt.checkpoint``.

Under ``Runtime.rules`` on a rank mesh the Mamba layers run on this
rank's ssm heads (:func:`repro_torch.models.ssm.mamba_block`), the
shared block's attention on its heads and its SwiGLU on its columns and
rows (tensor parallelism, as the dense family's), the vocabulary as
:mod:`~repro_torch.models.transformer` takes it; each group's ``"data"``
blocks (its Mamba layers' and the shared block's) are gathered inside
its region.  The decode state of a rank holds its ssm heads, its conv
channels and its kv heads (:func:`cache_specs` with ``tp``).  Over a
sequence that ``Runtime.on_sequence`` splits (``seq_model``,
``megatron_seq``) each group's norm sites run on this rank's rows, and
its Mamba blocks, the shared attention and the shared SwiGLU each run
between a gather and a reduce-scatter, as the dense family's mixers do;
under ``ssm_seq`` the Mamba blocks and the shared SwiGLU run on the rows
(the state handed from rank to rank), the shared attention over the
gathered sequence.
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


def _mamba_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": layers.norm_specs(cfg.d_model),
            "ssm": ssm.ssm_specs(cfg)}


def _shared_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn_norm": layers.norm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg),
        "ffn_norm": layers.norm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def hybrid_specs(cfg: ModelConfig) -> Dict[str, Any]:
    g, k = _groups(cfg)
    return {
        "embed": transformer.embed_spec(cfg),
        "mamba_layers": layers.map_specs(
            lambda s: s.stack_layers(k).stack_layers(g), _mamba_specs(cfg)),
        "shared_block": _shared_specs(cfg),
        "final_norm": layers.norm_specs(cfg.d_model),
        "lm_head": transformer.head_spec(cfg),
    }


def unstack_groups(stacked: PyTree) -> List[List[PyTree]]:
    """The ``(G, attn_every, ...)`` Mamba layers as ``[g][i]`` per-layer
    trees of views (:func:`repro_torch.models.transformer.
    unstack_layers` on both leading dims)."""
    return [transformer.unstack_layers(group)
            for group in transformer.unstack_layers(stacked)]


def _shared_block(p: Dict[str, Any], cfg: ModelConfig, rt: Runtime,
                  attn: Callable) -> List[Site]:
    """The shared block's two norm sites: ``attn(h)`` after the attention
    norm, the SwiGLU MLP (on this rank's columns and rows where they
    split) after the FFN norm."""
    m = p["mlp"]
    axis = layers.split_axis(m["w_gate"].shape[-1], cfg.d_ff, rt, "the MLP")
    return [(p["attn_norm"]["scale"], attn),
            (p["ffn_norm"]["scale"],
             lambda h: layers.swiglu(h, m["w_gate"], m["w_up"],
                                     m["w_down"], axis, rt.seq_axis(),
                                     rt.seq_rows))]


def _walk(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
          mamba: Callable, attn: Callable, region: Callable = lambda fn: fn
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack over the embedded x.  ``mamba(p, h, g, i)`` runs Mamba
    layer ``[g][i]`` and ``attn(p, h, g)`` the shared block's attention
    ``p`` in group ``g``.  Each group's sites (its Mamba layers and the
    shared block, the reference's super block) run as one ``region(fn)(y,
    x)``, their ``"data"`` blocks gathered inside it: ``rt.checkpoint``
    on the full sequence, the identity in a decode step.  Returns ``(x,
    y)``: the residual stream and the last site's output, not yet added
    (the final norm adds it as it normalises)."""
    eps = cfg.norm_eps
    mamba_specs, shared_specs = _mamba_specs(cfg), _shared_specs(cfg)

    def run_group(g: int, group: List[PyTree]) -> Callable:
        def run(y, x):
            shared = layers.gather_fsdp(params["shared_block"], shared_specs,
                                        rt)
            here = [layers.gather_fsdp(lp, mamba_specs, rt) for lp in group]
            sites = [(lp["norm"]["scale"],
                      lambda h, p=lp["ssm"], i=i: mamba(p, h, g, i))
                     for i, lp in enumerate(here)] + \
                _shared_block(shared, cfg, rt,
                              lambda h: attn(shared["attn"], h, g))
            for scale, fn in sites:
                h, x = layers.open_norm(rt, y, x, scale, eps)
                y = fn(h)
            return x, y
        return run

    y = None
    for g, group in enumerate(unstack_groups(params["mamba_layers"])):
        x, y = region(run_group(g, group))(y, x)
    return x, y


def _final_norm(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                y: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return layers.open_norm(rt, y, x, params["final_norm"]["scale"],
                            cfg.norm_eps)[0]


def _stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_walk` over a full sequence of embedded x (B, S, d),
    positions 0..S-1 (this rank's rows where ``rt`` splits it)."""
    positions = torch.arange(layers.stream_len(x, rt), device=x.device)[None]
    rope = layers.rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta,
                               compute_dtype(x.dtype))
    return _walk(params, cfg, x, rt,
                 lambda p, h, g, i: ssm.mamba_block(p, cfg, h, rt),
                 lambda p, h, g: attention.full_attention(p, cfg, h, True,
                                                          rt, rope),
                 rt.checkpoint)


def forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
            rt: Runtime) -> torch.Tensor:
    """The hybrid stack on embedded inputs x (B, S, d) -> the hidden
    states (B, S, d) before the final norm, as the reference returns
    them (gathered whole where the sequence splits)."""
    rt = rt.on_sequence(x.shape[1], cfg)
    x, y = _stack(params, cfg, layers.split_seq(x, rt), rt)
    return layers.gather_seq(x + y, rt)


def _hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            rt: Runtime) -> torch.Tensor:
    """The final-normed hidden states over ``tokens`` (B, S), this rank's
    rows where ``rt`` (on the sequence) splits it."""
    x, y = _stack(params, cfg, transformer.embed(params, cfg, tokens, rt),
                  rt)
    return _final_norm(params, cfg, x, y, rt)


def hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
           rt: Runtime) -> torch.Tensor:
    """The full-sequence stack over ``tokens`` (B, S) -> the final-normed
    hidden states (B, S, d), whole."""
    rt = rt.on_sequence(tokens.shape[1], cfg)
    return layers.gather_seq(_hidden(params, cfg, tokens, rt), rt)


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
            rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy (with the z-loss) over ``batch["tokens"]``
    (B, S); ``batch["mask"]`` marks the valid target positions.  Returns
    a float32 scalar."""
    tokens = batch["tokens"]
    mask = batch.get("mask")
    rt = rt.on_sequence(tokens.shape[1], cfg)
    return transformer.next_token_loss(
        params, cfg, _hidden(params, cfg, tokens, rt), tokens[:, 1:],
        None if mask is None else mask[:, 1:], rt, slice(None, -1))


# ---------------------------------------------------------------------------
# Decode: SSM states for every Mamba layer + ONE KV cache for the shared
# block per invocation group (the shared block attends at G points).
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1
                ) -> Dict[str, ParamSpec]:
    """The decode state; with ``tp`` a rank's under tensor parallelism
    over that many ranks (its ssm heads and conv channels,
    :func:`repro_torch.models.ssm.ssm_cache_specs`, and its kv heads,
    :func:`repro_torch.models.attention.kv_heads_split`)."""
    g, k = _groups(cfg)
    ssm_specs = ssm.ssm_cache_specs(cfg, batch, n_layers=k, tp=tp)
    kv = attention.kv_cache_specs(cfg, batch, max_len, n_layers=g,
                                  kv_heads=attention.kv_heads_split(cfg, tp))
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
    x, y = _walk(params, cfg, transformer.embed(params, cfg, tokens, rt), rt,
                 lambda p, h, g, i: ssm.mamba_decode_block(
                     p, cfg, h, cache["ssm_state"][g, i],
                     cache["conv_state"][g, i], rt, rows),
                 lambda p, h, g: attention.decode_attention(
                     p, cfg, h, cache["k"][g], cache["v"][g], position,
                     rt, rows, rope))
    h = _final_norm(params, cfg, x, y, rt)
    return transformer.unembed(params, cfg, h, rt)[:, 0], cache
