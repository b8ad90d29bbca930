"""Decoder-only LM, dense and MoE families (and the vlm's backbone):
full-sequence forward, loss, prefill and one-token decode.

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
calls per forward (or step); qwen2-moe-a2.7b 1 / 48 / 24 and
deepseek-moe-16b 1 / 56 / 28.  The FFN is a SwiGLU, or for the MoE
family :func:`repro_torch.models.moe.moe_block`, whose aux loss the
forward sums over the layers and :func:`lm_loss` adds.  The big
projections stay ``torch.matmul``, as the reference left them to XLA.
Under ``Runtime(remat=...)`` each layer of the full-sequence stack is
one region of ``rt.checkpoint`` (:func:`_stack`).

Under ``Runtime.rules`` on a rank mesh the dense family runs on this
rank's blocks of the parameters (``layers.shard_params``): its heads
(:mod:`~repro_torch.models.attention`), its SwiGLU columns and rows, and
its rows of the vocabulary (:func:`embed` masks the lookup to them and
sums over ``"model"``, :func:`unembed` gives this rank's logits, which
the loss takes vocabulary-parallel and the serving entry points gather
whole).  A layer's blocks over ``"data"`` (FSDP) are gathered inside its
checkpointed region, just before use, so that under remat the gather
reruns in the backward and the whole weight is not kept.  Under
``seq_model`` and ``megatron_seq`` every full-sequence entry point asks
``Runtime.on_sequence`` whether its sequence splits; where it does,
:func:`embed` hands each rank its rows (the vocabulary-parallel lookup
reduce-scattered, a whole table's lookup split), the blocks run on them
(the norm sites on the rows, each mixer between a gather and a
reduce-scatter, the MoE's routed experts over the gathered tokens; under
``ssm_seq`` the SwiGLU and the shared experts on the rows with their
weights whole, the attention over the gathered sequence), and
the final-normed rows are gathered for the head (:func:`next_token_loss`,
:func:`prefill_embedded`).  A region's two boundary tensors are then a
rank's rows.
The ssm, hybrid and encdec families have their own stacks
(:mod:`~repro_torch.models.registry`, :mod:`~repro_torch.models.hybrid`,
:mod:`~repro_torch.models.encdec`); :mod:`~repro_torch.models.vlm`
prepends projected patches to this stack.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import ranks
from repro_torch.models import attention, layers, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute_dtype

PyTree = Any

DECODER_FAMILIES = ("dense", "moe", "vlm")


def _decoder_only(cfg: ModelConfig) -> None:
    """Refuse a config whose family has no decoder-only stack here (the
    ssm, hybrid and encdec families have their own)."""
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family has no "
                         f"decoder-only stack (one of {DECODER_FAMILIES})")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _decoder_only(cfg)
    specs = {
        "attn_norm": layers.norm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg),
        "ffn_norm": layers.norm_specs(cfg.d_model),
    }
    if cfg.moe is not None:
        specs["moe"] = moe.moe_specs(cfg)
    else:
        specs["mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff)
    return specs


def stack_specs(specs: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """``specs`` (one layer's) stacked ``n_layers`` deep."""
    return layers.map_specs(lambda s: s.stack_layers(n_layers), specs)


def stack_block_specs(cfg: ModelConfig, n_layers: int) -> Dict[str, Any]:
    return stack_specs(block_specs(cfg), n_layers)


def embed_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "fsdp_embed"))


def head_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model, cfg.vocab_size), ("fsdp_embed", "vocab"))


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = {
        "embed": embed_spec(cfg),
        "layers": stack_block_specs(cfg, cfg.n_layers),
        "final_norm": layers.norm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = head_spec(cfg)
    return specs


# ---------------------------------------------------------------------------
# Blocks and decode
# ---------------------------------------------------------------------------

def _ffn(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor, rt: Runtime
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed h (B, S, d): (y, the MoE aux loss —
    None for a SwiGLU).  The MoE splits its experts over ``rt.ep_axis``
    when the mesh gives that axis more than one rank, as the reference's
    ``_ffn`` does.  There h is this rank's data shard (its rows over
    ``("pod", "data")``, the same on every rank of ``rt.ep_axis``: the
    reference's ``tok_spec``), the capacity comes from those tokens, and
    the aux loss is this rank's; what a train step reports is
    :mod:`repro_torch.train.steps`' to say.  Under the rules' layout the
    shared experts run on this rank's columns and rows (tensor
    parallelism, as the SwiGLU's), the routed experts split over
    ``rt.ep_axis`` as they are without rules, the router whole.  Over a
    split sequence h is this rank's rows and so is y."""
    seq = rt.seq_axis()
    if cfg.moe is None:
        m = p["mlp"]
        axis = layers.split_axis(m["w_gate"].shape[-1], cfg.d_ff, rt,
                                 "the MLP")
        return layers.swiglu(h, m["w_gate"], m["w_up"], m["w_down"],
                             axis, seq, rt.seq_rows), None
    shared = p["moe"].get("shared")
    axis = None if shared is None else layers.split_axis(
        shared["w_gate"].shape[-1], cfg.moe.n_shared * cfg.moe.d_ff_expert,
        rt, "the shared experts")
    if rt.moe_ep_size() > 1:
        return moe.moe_block(p["moe"], cfg, h, ep_axis=rt.ep_axis,
                             mesh=rt.mesh, shared_axis=axis, seq=seq,
                             rows=rt.seq_rows)
    return moe.moe_block(p["moe"], cfg, h, shared_axis=axis, seq=seq,
                         rows=rt.seq_rows)


def kv_heads_here(params: PyTree, cfg: ModelConfig) -> int:
    """The kv heads of this rank's cache: all of them, or under tensor
    parallelism those its q heads read (``attention.kv_heads_here``)."""
    return attention.kv_heads_here(cfg,
                                   params["layers"]["attn"]["wq"].shape[-2])


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


def embed(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
          rt: Optional[Runtime] = None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the weights' dtype.  Where this rank
    holds rows [i V, (i + 1) V) of the vocabulary, the lookup reads the
    tokens among them and the ranks' lookups are summed (one is nonzero
    at each position).  Where ``rt.seq_axis()`` splits the sequence, this
    rank's rows of the sequence: the sum reduce-scattered over it, or a
    whole table's lookup split."""
    w = params["embed"] if rt is None else \
        layers.gather_fsdp(params["embed"], embed_spec(cfg), rt)
    axis = layers.split_axis(w.shape[0], cfg.vocab_size, rt,
                             "the embedding")
    seq = None if rt is None else rt.seq_axis()
    if axis is None:
        x = w[tokens.long()]
        return x if seq is None else ranks.split_to(x, seq, 1)
    n = w.shape[0]
    local = tokens.long() - axis.index * n
    inside = ((local >= 0) & (local < n))[..., None]
    rows = torch.where(inside, w[local.clamp(0, n - 1)], 0)
    if seq is None:
        return ranks.reduce_from(rows, axis)
    return ranks.reduce_scatter_to(rows, seq, 1)


def _head(params: PyTree, cfg: ModelConfig, rt: Optional[Runtime]
          ) -> Tuple[torch.Tensor, Optional[ranks.Axis]]:
    """The head's (d, V) weight as this rank reads it (tied weights: the
    embedding's transpose), and the tensor-parallel axis when it holds
    part of the vocabulary."""
    if cfg.tie_embeddings:
        w = params["embed"] if rt is None else \
            layers.gather_fsdp(params["embed"], embed_spec(cfg), rt)
        w = w.T
    else:
        w = params["lm_head"] if rt is None else \
            layers.gather_fsdp(params["lm_head"], head_spec(cfg), rt)
    return w, layers.split_axis(w.shape[1], cfg.vocab_size, rt,
                                "the unembedding")


def unembed(params: PyTree, cfg: ModelConfig, h: torch.Tensor,
            rt: Optional[Runtime] = None) -> torch.Tensor:
    """Final-normed hidden (B, S, d), whole, -> logits (B, S, V) for
    serving (no gradient; the loss is :func:`next_token_loss`); tied
    weights read the embedding (``x @ embed.T``).  Where this rank holds
    part of the vocabulary, its logits (B, S, V / n) gathered whole."""
    w, axis = _head(params, cfg, rt)
    if axis is None:
        return h @ w
    return ranks.all_gather(h @ w, axis, -1)


def decode_block(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
                 x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, position: torch.Tensor,
                 rt: Runtime, rows=None, rope=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block on the attention-normed input ``h`` and the
    residual stream ``x`` (B, 1, d).  Returns ``(x, y)``: the residual
    after the attention and the FFN output — the next norm site adds
    ``y`` to ``x`` (the reference's ``x + y``) as it normalises.  The
    MoE aux loss is dropped, as in the reference."""
    a = attention.decode_attention(p["attn"], cfg, h, k_cache, v_cache,
                                   position, rt, rows, rope)
    h, x = rt.op("rms_norm_residual")(a, x, p["ffn_norm"]["scale"],
                                      cfg.norm_eps)
    return x, _ffn(p, cfg, h, rt)[0]


def decode_step(params: PyTree, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, position: torch.Tensor, rt: Runtime,
                valid=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) int; position: (B,) int — each
    row's write index; cache {k, v: (L, B, S_max, Hkv, D)}, updated IN
    PLACE at the rows where the ``(B,)`` bool ``valid`` holds (every row
    for ``None``): host rows (numpy) or a device mask (a bool tensor; no
    host read, see :mod:`repro_torch.models.masking`).  Returns
    ``(logits (B, V), cache)`` — the same cache dict.  An MoE step routes
    its B rows together (capacity of B tokens), valid or not."""
    _decoder_only(cfg)
    position = position.to(torch.int32)
    rows = valid_rows(valid, position.device)
    rope = layers.rope_cos_sin(position[:, None], cfg.head_dim_,
                               cfg.rope_theta)
    x = embed(params, cfg, tokens, rt)
    h = rt.op("rms_norm")(x, params["layers"]["attn_norm"]["scale"][0],
                          cfg.norm_eps)
    specs = block_specs(cfg)
    for i in range(cfg.n_layers):
        p = layers.gather_fsdp(layer_params(params["layers"], i), specs, rt)
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["attn_norm"]["scale"],
                                              cfg.norm_eps)
        x, y = decode_block(p, cfg, h, x, cache["k"][i], cache["v"][i],
                            position, rt, rows, rope)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return unembed(params, cfg, h, rt)[:, 0], cache


# ---------------------------------------------------------------------------
# Full-sequence forward, loss and prefill
# ---------------------------------------------------------------------------

def block(p: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
          x: torch.Tensor, rt: Runtime, rope=None, cache=None
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One decoder block over a full sequence, on the attention-normed
    input ``h`` and the residual stream ``x`` (B, S, d), positions
    0..S-1.  Returns ``(x, y, aux)``: as :func:`decode_block` does, and
    the MoE aux loss (None for a SwiGLU).  ``cache`` is a ``(k_cache,
    v_cache)`` pair of (B, S_max, Hkv, D) tensors whose rows [0, S)
    receive the block's k and v (in place)."""
    a, k, v = attention.full_attention_kv(p["attn"], cfg, h, True, rt, rope)
    if cache is not None:
        s = k.shape[1]                # the whole sequence's
        cache[0][:, :s] = k.to(cache[0].dtype)
        cache[1][:, :s] = v.to(cache[1].dtype)
    h, x = layers.open_norm(rt, a, x, p["ffn_norm"]["scale"], cfg.norm_eps)
    return (x, *_ffn(p, cfg, h, rt))


def _stack(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime,
           cache: Optional[Dict[str, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every block over the embedded x (B, S, d).  Returns ``(x, y,
    aux)``: the residual stream, the last block's FFN output, not yet
    added (the final norm adds it as it normalises), and the MoE aux
    loss summed over the layers (None without MoE).

    Layer i is one region of ``rt.checkpoint``: its opening norm (which
    adds the previous block's FFN output) and the block, from ``(y, x)``
    to ``(x, y, aux)``.  The fused norm puts two (B, S, d) tensors at
    each region boundary where the reference's scan carries one (a
    rank's rows of each over a split sequence).  The cache writes of
    :func:`prefill` run without grad, where the checkpoint is the
    identity."""
    _decoder_only(cfg)
    rope = layers.rope_cos_sin(
        torch.arange(layers.stream_len(x, rt), device=x.device)[None],
        cfg.head_dim_, cfg.rope_theta, compute_dtype(x.dtype))

    specs = block_specs(cfg)

    def region(p, kv):
        def run(y, x):
            q = layers.gather_fsdp(p, specs, rt)
            h, x = layers.open_norm(rt, y, x, q["attn_norm"]["scale"],
                                    cfg.norm_eps)
            return block(q, cfg, h, x, rt, rope, kv)
        return run

    y = aux = None
    for i, p in enumerate(unstack_layers(params["layers"])):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        x, y, a = rt.checkpoint(region(p, kv))(y, x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, y, aux


def forward(params: PyTree, cfg: ModelConfig, x: torch.Tensor, rt: Runtime
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack on embedded inputs x (B, S, d).  Returns (hidden
    (B, S, d) before the final norm, the MoE aux loss summed over the
    layers — 0 for the dense family), as the reference does.  Over a
    split sequence the stack runs on this rank's rows of x and the
    hidden states are gathered whole."""
    rt = rt.on_sequence(x.shape[1], cfg)
    x, y, aux = _stack(params, cfg, layers.split_seq(x, rt), rt)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return layers.gather_seq(x + y, rt), aux


def lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
            rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy (with the z-loss) over ``batch["tokens"]``
    (B, S), plus the MoE aux loss; ``batch["mask"]`` (B, S), when given,
    marks the valid target positions.  Returns a float32 scalar."""
    loss, aux = lm_loss_terms(params, cfg, batch, rt)
    return loss if aux is None else loss + aux


def lm_loss_terms(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
                  rt: Runtime
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`lm_loss`'s two terms: the cross entropy and the MoE aux
    loss summed over the layers (None without MoE)."""
    tokens = batch["tokens"]
    rt = rt.on_sequence(tokens.shape[1], cfg)
    x, y, aux = _stack(params, cfg, embed(params, cfg, tokens, rt), rt)
    h, _ = layers.open_norm(rt, y, x, params["final_norm"]["scale"],
                            cfg.norm_eps)
    mask = batch.get("mask")
    loss = next_token_loss(params, cfg, h, tokens[:, 1:],
                           None if mask is None else mask[:, 1:], rt,
                           slice(None, -1))
    return loss, aux


def next_token_loss(params: PyTree, cfg: ModelConfig, h: torch.Tensor,
                    labels: torch.Tensor, mask: Optional[torch.Tensor],
                    rt: Runtime, rows: slice = slice(None)) -> torch.Tensor:
    """The cross entropy of the logits of the final-normed ``h`` (B, S,
    d) at the positions ``rows`` against ``labels`` (B, len(rows))
    (``layers.cross_entropy_loss``), taken vocabulary-parallel where
    this rank holds part of the vocabulary: every family's loss.  Where
    ``rt.seq_axis()`` splits the sequence, ``h`` is this rank's rows of
    it, gathered whole for the head (``layers.enter``)."""
    w, axis = _head(params, cfg, rt)
    seq = rt.seq_axis()
    if seq is None:
        h = layers.enter(h[:, rows], axis, None)
    else:
        h = layers.enter(h, axis, seq)[:, rows]
    return layers.cross_entropy_loss(h @ w, labels, mask, vocab_axis=axis)


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
    rt = rt.on_sequence(tokens.shape[1], cfg)
    return prefill_embedded(params, cfg, embed(params, cfg, tokens, rt),
                            rt, cache)


def prefill_embedded(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                     rt: Runtime,
                     cache: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`prefill` over the embedded positions x (B, S, d) (the vlm
    prepends its projected patches), this rank's rows of them where
    ``rt`` (on the sequence, ``Runtime.on_sequence``) splits it: each
    rank writes the cache at every position of its kv heads, and the
    last position's final-normed row is gathered from the last rank."""
    _decoder_only(cfg)
    b, s = x.shape[0], layers.stream_len(x, rt)
    shape = (cfg.n_layers, b, s, kv_heads_here(params, cfg),
             cfg.head_dim_)
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
    x, y, _ = _stack(params, cfg, x, rt, cache)
    h, _ = rt.op("rms_norm_residual")(y[:, -1:], x[:, -1:],
                                      params["final_norm"]["scale"],
                                      cfg.norm_eps)
    h = layers.gather_seq(h, rt)[:, -1:]
    return unembed(params, cfg, h, rt)[:, 0], cache
