"""Encoder-decoder transformer (the SeamlessM4T-medium backbone).

The port of ``repro.models.encdec``.  The speech/text frontend is a
stub, as in the reference: the encoder takes precomputed frame
embeddings (B, S_src, d_model), cast to the weights' dtype.  The encoder
is a non-causal stack; the decoder a causal stack with cross attention
over the encoder's output.  RoPE and RMSNorm, as in the reference.

The norm sites fuse as in :mod:`~repro_torch.models.transformer`: each
stack's first norm is ``rms_norm``, every later one (with the
residual add before it) and the stack's final norm one
``rms_norm_residual``.  Self attention over a whole sequence is
``flash_attention`` (non-causal in the encoder, causal in the decoder);
the cross attention of :func:`decode_train` is the plain
:func:`repro_torch.models.attention.cross_attention`.  For
seamless-m4t-medium (12 + 12 layers) a loss makes 2 ``rms_norm``, 60
``rms_norm_residual`` and 24 ``flash_attention`` calls (12 of them
non-causal).

:func:`decode_step` runs the decoder one token against its self-KV cache
(``flash_decode`` with a per-row length) and the precomputed cross
cache (``flash_decode`` over all ``src_len`` positions of every row: the
same function as the reference's unmasked one-query attention): 24
``flash_decode`` calls a step.  The cross q is rotated at each row's own
position; the reference takes one scalar position for the whole batch.

Under ``Runtime.rules`` on a rank mesh both stacks run on this rank's
heads (the encoder's non-causal attention, the decoder's self and cross
attention: its q heads over its kv heads of the memory) and its SwiGLU
columns and rows, the vocabulary as
:mod:`~repro_torch.models.transformer` takes it; each layer's
``"data"`` blocks are gathered inside its region.  The self and the
cross cache of a rank hold its kv heads (:func:`cache_specs` with
``tp``).  Under ``seq_model``, ``megatron_seq`` and ``ssm_seq`` each
stream splits on its own (``Runtime.on_sequence``: the frames' length for the encoder,
the tokens' for the decoder): its norm sites run on this rank's rows,
every mixer between a gather and a reduce-scatter, and the encoder's
normed memory is gathered whole once a forward, for every layer's cross
attention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention, layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute_dtype

PyTree = Any


def _enc_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn_norm": layers.norm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg),
        "ffn_norm": layers.norm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _dec_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = _enc_block_specs(cfg)
    specs["cross_norm"] = layers.norm_specs(cfg.d_model)
    specs["cross"] = attention.attn_specs(cfg)
    return specs


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    e = cfg.encdec
    return {
        "embed": transformer.embed_spec(cfg),
        "encoder": layers.map_specs(
            lambda s: s.stack_layers(e.n_encoder_layers),
            _enc_block_specs(cfg)),
        "decoder": layers.map_specs(
            lambda s: s.stack_layers(e.n_decoder_layers),
            _dec_block_specs(cfg)),
        "enc_norm": layers.norm_specs(cfg.d_model),
        "final_norm": layers.norm_specs(cfg.d_model),
        "lm_head": transformer.head_spec(cfg),
    }


def _rope(cfg: ModelConfig, x: torch.Tensor, rt: Optional[Runtime] = None):
    """The ``(cos, sin)`` of the whole sequence of the stream ``x`` (of
    which this rank holds its rows where ``rt`` splits it)."""
    s = x.shape[1] if rt is None else layers.stream_len(x, rt)
    return layers.rope_cos_sin(torch.arange(s, device=x.device)[None],
                               cfg.head_dim_, cfg.rope_theta,
                               compute_dtype(x.dtype))


def _swiglu(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
            rt: Runtime) -> torch.Tensor:
    m = p["mlp"]
    axis = layers.split_axis(m["w_gate"].shape[-1], cfg.d_ff, rt, "the MLP")
    return layers.swiglu(h, m["w_gate"], m["w_up"], m["w_down"], axis,
                         rt.seq_axis(), rt.seq_rows)


def encode(params: PyTree, cfg: ModelConfig, frames: torch.Tensor,
           rt: Runtime) -> torch.Tensor:
    """frames (B, S_src, d_model), the stubbed frontend's output -> the
    normed memory (B, S_src, d_model), whole.  Layer i (its opening norm
    and block) is one region of ``rt.checkpoint``."""
    rt = rt.on_sequence(frames.shape[1], cfg)
    x = layers.split_seq(frames.to(params["embed"].dtype), rt)
    rope = _rope(cfg, x, rt)
    specs = _enc_block_specs(cfg)

    def region(layer):
        def run(y, x):
            p = layers.gather_fsdp(layer, specs, rt)
            h, x = layers.open_norm(rt, y, x, p["attn_norm"]["scale"],
                                    cfg.norm_eps)
            a = attention.full_attention(p["attn"], cfg, h, False, rt, rope)
            h, x = layers.open_norm(rt, a, x, p["ffn_norm"]["scale"],
                                    cfg.norm_eps)
            return x, _swiglu(p, cfg, h, rt)
        return run

    y = None
    for p in transformer.unstack_layers(params["encoder"]):
        x, y = rt.checkpoint(region(p))(y, x)
    return layers.gather_seq(layers.open_norm(
        rt, y, x, params["enc_norm"]["scale"], cfg.norm_eps)[0], rt)


def _decoder(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
             memory: torch.Tensor, rt: Runtime
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack over ``tokens`` (B, S) and the whole ``memory``:
    (the residual stream, the last block's FFN output not yet added),
    this rank's rows of both where ``rt`` (on the tokens' sequence)
    splits it.  Layer i is one region of ``rt.checkpoint``, as in
    :func:`encode`."""
    x = transformer.embed(params, cfg, tokens, rt)
    rope = _rope(cfg, x, rt)
    specs = _dec_block_specs(cfg)

    def region(layer):
        def run(y, x):
            p = layers.gather_fsdp(layer, specs, rt)
            h, x = layers.open_norm(rt, y, x, p["attn_norm"]["scale"],
                                    cfg.norm_eps)
            a = attention.full_attention(p["attn"], cfg, h, True, rt, rope)
            h, x = layers.open_norm(rt, a, x, p["cross_norm"]["scale"],
                                    cfg.norm_eps)
            c = attention.cross_attention(p["cross"], cfg, h, memory, rope,
                                          rt)
            h, x = layers.open_norm(rt, c, x, p["ffn_norm"]["scale"],
                                    cfg.norm_eps)
            return x, _swiglu(p, cfg, h, rt)
        return run

    y = None
    for p in transformer.unstack_layers(params["decoder"]):
        x, y = rt.checkpoint(region(p))(y, x)
    return x, y


def decode_train(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                 memory: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The decoder over ``tokens`` (B, S) and ``memory``: its hidden
    states (B, S, d) before the final norm, as the reference's (whole)."""
    rt = rt.on_sequence(tokens.shape[1], cfg)
    x, y = _decoder(params, cfg, tokens, memory, rt)
    return layers.gather_seq(x + y, rt)


def seq2seq_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
                 rt: Runtime) -> torch.Tensor:
    """batch: frames (B, S_src, d), tokens (B, S_tgt) targets, optionally
    mask (B, S_tgt).  The decoder reads tokens[:, :-1] and predicts
    tokens[:, 1:].  Returns a float32 scalar."""
    memory = encode(params, cfg, batch["frames"], rt)
    tokens = batch["tokens"]
    rt = rt.on_sequence(tokens.shape[1] - 1, cfg)
    x, y = _decoder(params, cfg, tokens[:, :-1], memory, rt)
    h, _ = layers.open_norm(rt, y, x, params["final_norm"]["scale"],
                            cfg.norm_eps)
    mask = batch.get("mask")
    return transformer.next_token_loss(params, cfg, h, tokens[:, 1:],
                                       None if mask is None else mask[:, 1:],
                                       rt)


# ---------------------------------------------------------------------------
# Decode with the self-KV cache and the precomputed cross cache
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
                tp: int = 1) -> Dict[str, ParamSpec]:
    """The self and the cross cache; with ``tp`` a rank's under tensor
    parallelism over that many ranks (its kv heads,
    :func:`repro_torch.models.attention.kv_heads_split`)."""
    nl = cfg.encdec.n_decoder_layers
    hkv = attention.kv_heads_split(cfg, tp)
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    self_kv = (nl, batch, max_len, hkv, cfg.head_dim_)
    cross = (nl, batch, src_len, hkv, cfg.head_dim_)
    return {"k": ParamSpec(self_kv, kv), "v": ParamSpec(self_kv, kv),
            "cross_k": ParamSpec(cross, kv), "cross_v": ParamSpec(cross, kv)}


def decode_step(params: PyTree, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, position: torch.Tensor, rt: Runtime,
                valid=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder step.  tokens (B, 1) int; position (B,) int, each
    row's write index; cache {k, v: (L, B, S_max, Hkv, D), cross_k,
    cross_v: (L, B, S_src, Hkv, D)}: the self cache is updated IN PLACE
    at the valid rows (as :func:`repro_torch.models.transformer.
    decode_step`), the cross cache only read.  Returns ``(logits (B, V),
    cache)`` — the same cache dict."""
    position = position.to(torch.int32)
    rows = valid_rows(valid, position.device)
    rope = layers.rope_cos_sin(position[:, None], cfg.head_dim_,
                               cfg.rope_theta)
    b = tokens.shape[0]
    src_len = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=position.device)
    x = transformer.embed(params, cfg, tokens, rt)
    h = rt.op("rms_norm")(x, params["decoder"]["attn_norm"]["scale"][0],
                          cfg.norm_eps)
    specs = _dec_block_specs(cfg)
    for i in range(cfg.encdec.n_decoder_layers):
        p = layers.gather_fsdp(transformer.layer_params(params["decoder"], i),
                               specs, rt)
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["attn_norm"]["scale"],
                                              cfg.norm_eps)
        a = attention.decode_attention(p["attn"], cfg, h, cache["k"][i],
                                       cache["v"][i], position, rt, rows,
                                       rope)
        h, x = rt.op("rms_norm_residual")(a, x, p["cross_norm"]["scale"],
                                          cfg.norm_eps)
        cross = p["cross"]
        q = attention._heads(h, cross["wq"])
        if cfg.qkv_bias:
            q = q + cross["bq"]
        q = layers.rotate(q, *rope)
        o = rt.op("flash_decode")(q[:, 0], cache["cross_k"][i],
                                  cache["cross_v"][i], src_len)
        c = attention._out(cross, o[:, None],
                           attention.tp_axis(cross, cfg, rt))
        h, x = rt.op("rms_norm_residual")(c, x, p["ffn_norm"]["scale"],
                                          cfg.norm_eps)
        y = _swiglu(p, cfg, h, rt)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return transformer.unembed(params, cfg, h, rt)[:, 0], cache
