"""Decoder-only LM, dense family: full-sequence forward, loss, prefill
and one-token decode.

The layers' parameters are stacked (leading ``layers`` axis, as in the
reference) and every entry point walks them in a Python loop.  The norm
sites and the attention go through the :class:`Runtime`'s kernel sites:

* layer 0's attention norm and the per-head q-/k-norms are ``rms_norm``;
* every ``x = x + y; h = norm(x)`` — each FFN norm, the attention norm of
  layers >= 1 (adding the previous layer's FFN output) and the final
  norm — is one fused ``rms_norm_residual``;
* the attention of a whole sequence (:func:`forward`, :func:`lm_loss`,
  :func:`prefill`) is ``flash_attention``, causal; the one-token
  attention of :func:`decode_step` is ``flash_decode`` with a per-row
  length.

For qwen3-1.7b (28 layers, qk-norm) that is 57 ``rms_norm``, 56
``rms_norm_residual`` and 28 ``flash_attention`` (or ``flash_decode``)
calls per forward (or step).  The big projections stay ``torch.matmul``,
as the reference left them to XLA.  The ssm and hybrid families have
their own stacks (:mod:`~repro_torch.models.registry`,
:mod:`~repro_torch.models.hybrid`); the MoE, vlm and encdec families
come with a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute_dtype

PyTree = Any

FAMILIES_ITEM = "ROADMAP.md item 12 (the other model families)"


def _dense_only(cfg: ModelConfig) -> None:
    """Refuse every config but the dense family's: the MoE, vlm and
    encdec families (and a family name without its sub-config) are not
    ported yet."""
    if cfg.moe is not None or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; it "
            f"comes with {FAMILIES_ITEM}, a later slice of the port")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _dense_only(cfg)
    return {
        "attn_norm": layers.norm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg),
        "ffn_norm": layers.norm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def stack_block_specs(cfg: ModelConfig, n_layers: int) -> Dict[str, Any]:
    return layers.map_specs(lambda s: s.stack_layers(n_layers),
                            block_specs(cfg))


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "fsdp_embed")),
        "layers": stack_block_specs(cfg, cfg.n_layers),
        "final_norm": layers.norm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("fsdp_embed", "vocab"))
    return specs


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def layer_params(stacked: PyTree, i: int) -> PyTree:
    """Layer ``i``'s slice of the stacked layer parameters (views)."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    return {k: layer_params(v, i) for k, v in stacked.items()}


def unstack_layers(stacked: PyTree) -> List[PyTree]:
    """Every layer's slice of the stacked layer parameters — the views of
    :func:`layer_params` — with each leaf taken apart once by
    ``torch.unbind``.  Under autograd its backward is one ``stack`` per
    leaf, where one ``stacked[i]`` per layer would zero-fill and add into
    a full-size gradient for every layer."""
    if isinstance(stacked, torch.Tensor):
        return list(torch.unbind(stacked))
    per_key = {k: unstack_layers(v) for k, v in stacked.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def embed(params: PyTree, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the weights' dtype."""
    return params["embed"][tokens.long()]


def unembed(params: PyTree, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden (B, S, d) -> logits (B, S, V); tied weights
    read the embedding (``x @ embed.T``)."""
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def decode_block(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
                 x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, position: torch.Tensor,
                 rt: Runtime, rows=None, rope=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block on the attention-normed input ``h`` and the
    residual stream ``x`` (B, 1, d).  Returns ``(x, y)``: the residual
    after the attention and the FFN output — the next norm site adds
    ``y`` to ``x`` (the reference's ``x + y``) as it normalises."""
    a = attention.decode_attention(p["attn"], cfg, h, k_cache, v_cache,
                                   position, rt, rows, rope)
    h, x = rt.op("rms_norm_residual")(a, x, p["ffn_norm"]["scale"],
                                      cfg.norm_eps)
    m = p["mlp"]
    return x, layers.swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def decode_step(params: PyTree, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, position: torch.Tensor, rt: Runtime,
                valid=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) int; position: (B,) int — each
    row's write index; cache {k, v: (L, B, S_max, Hkv, D)}, updated IN
    PLACE at the rows where the ``(B,)`` bool ``valid`` holds (every row
    for ``None``): host rows (numpy) or a device mask (a bool tensor; no
    host read, see :mod:`repro_torch.models.masking`).  Returns ``(logits (B, V), cache)`` — the
    same cache dict."""
    _dense_only(cfg)
    position = position.to(torch.int32)
    rows = valid_rows(valid, position.device)
    rope = layers.rope_cos_sin(position[:, None], cfg.head_dim_,
                               cfg.rope_theta)
    x = embed(params, cfg, tokens)
    h = rt.op("rms_norm")(x, params["layers"]["attn_norm"]["scale"][0],
                          cfg.norm_eps)
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["attn_norm"]["scale"],
                                              cfg.norm_eps)
        x, y = decode_block(p, cfg, h, x, cache["k"][i], cache["v"][i],
                            position, rt, rows, rope)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return unembed(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# Full-sequence forward, loss and prefill
# ---------------------------------------------------------------------------

def block(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
          x: torch.Tensor, rt: Runtime, rope=None, cache=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block over a full sequence, on the attention-normed
    input ``h`` and the residual stream ``x`` (B, S, d), positions
    0..S-1.  Returns ``(x, y)`` as :func:`decode_block` does.  ``cache``
    is a ``(k_cache, v_cache)`` pair of (B, S_max, Hkv, D) tensors whose
    rows [0, S) receive the block's k and v (in place)."""
    a, k, v = attention.full_attention_kv(p["attn"], cfg, h, True, rt, rope)
    if cache is not None:
        s = h.shape[1]
        cache[0][:, :s] = k.to(cache[0].dtype)
        cache[1][:, :s] = v.to(cache[1].dtype)
    h, x = rt.op("rms_norm_residual")(a, x, p["ffn_norm"]["scale"],
                                      cfg.norm_eps)
    m = p["mlp"]
    return x, layers.swiglu(h, m["w_gate"], m["w_up"], m["w_down"])


def _stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
           cache: Optional[Dict[str, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block over the embedded x (B, S, d).  Returns ``(x, y)``: the
    residual stream and the last block's FFN output, not yet added (the
    final norm adds it as it normalises)."""
    _dense_only(cfg)
    rope = layers.rope_cos_sin(torch.arange(x.shape[1], device=x.device)[None],
                               cfg.head_dim_, cfg.rope_theta,
                               compute_dtype(x.dtype))
    per_layer = unstack_layers(params["layers"])
    h = rt.op("rms_norm")(x, per_layer[0]["attn_norm"]["scale"],
                          cfg.norm_eps)
    for i, p in enumerate(per_layer):
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["attn_norm"]["scale"],
                                              cfg.norm_eps)
        x, y = block(p, cfg, h, x, rt, rope,
                     None if cache is None else (cache["k"][i],
                                                 cache["v"][i]))
    return x, y


def forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack on embedded inputs x (B, S, d).  Returns (hidden
    (B, S, d) before the final norm, the MoE aux loss — 0 for the dense
    family), as the reference does."""
    x, y = _stack(params, cfg, x, rt)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
            rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy (with the z-loss) over ``batch["tokens"]``
    (B, S); ``batch["mask"]`` (B, S), when given, marks the valid target
    positions.  Returns a float32 scalar."""
    tokens = batch["tokens"]
    x, y = _stack(params, cfg, embed(params, cfg, tokens), rt)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    logits = unembed(params, cfg, h[:, :-1])
    mask = batch.get("mask")
    return layers.cross_entropy_loss(
        logits, tokens[:, 1:], None if mask is None else mask[:, 1:])


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            rt: Runtime, cache: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full causal forward over ``tokens`` (B, S) that also fills the KV
    cache.  Returns (last-position logits (B, V), cache {k, v: (L, B, S,
    Hkv, D)}), as the reference does.

    ``cache``, when given, is a preallocated {k, v: (L, B, S_max, Hkv,
    D)} with S_max >= S: its rows [0, S) are written IN PLACE (the rest
    is left as it is) and the same dict is returned, so that
    :func:`decode_step` continues from position S.  This is the port's
    in-place form of the reference's returned cache."""
    _dense_only(cfg)
    b, s = tokens.shape
    x = embed(params, cfg, tokens)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim_)
    if cache is None:
        cache = {k: torch.empty(shape, dtype=x.dtype, device=x.device)
                 for k in ("k", "v")}
    for k in ("k", "v"):
        got = tuple(cache[k].shape)
        if len(got) != 5 or got[:2] != shape[:2] or got[3:] != shape[3:] \
                or got[2] < s:
            raise ValueError(f"cache[{k!r}] is {got}; want (L, B, S_max, "
                             f"Hkv, D) = {shape[:2]} + (>= {s},) + "
                             f"{shape[3:]}")
    x, y = _stack(params, cfg, x, rt, cache)
    h, _ = rt.op("rms_norm_residual")(y[:, -1:], x[:, -1:],
                                      params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return unembed(params, cfg, h)[:, 0], cache
