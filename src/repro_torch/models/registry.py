"""Architecture registry: an architecture name resolves here.

For every architecture this module answers ``param_specs(cfg)`` (the full
parameter tree of ParamSpec leaves), ``loss_fn()`` (the full-sequence
forward and its loss), ``prefill_fn()`` and ``decode_fn()`` (the serving
entry points), ``input_specs(cfg, shape)`` (shape-and-dtype stand-ins
for every input, as ``meta`` tensors) and ``cache_specs(cfg, shape)``
(the decode-state tree).  The port runs all six families: ``dense`` and
``moe`` (:mod:`~repro_torch.models.transformer`,
:mod:`~repro_torch.models.moe`), ``ssm`` (Mamba2, assembled here over
:mod:`~repro_torch.models.ssm`), ``hybrid`` (Zamba2,
:mod:`~repro_torch.models.hybrid`), ``encdec``
(:mod:`~repro_torch.models.encdec`) and ``vlm``
(:mod:`~repro_torch.models.vlm`).  The configs live in
:mod:`repro_torch.configs`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import (attention, encdec, hybrid, layers, moe,
                                ssm, transformer, vlm)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime

PyTree = Any


# the sub-configs each family needs
SUB_CONFIGS = {"dense": (), "moe": ("moe",), "ssm": ("ssm",),
               "hybrid": ("hybrid", "ssm"), "encdec": ("encdec",),
               "vlm": ("vlm",)}


def _family(cfg: ModelConfig) -> str:
    """``cfg.family``, one of :data:`SUB_CONFIGS`; a family named
    without its sub-config raises ``ValueError``, an unknown one
    ``KeyError``."""
    if cfg.family not in SUB_CONFIGS:
        raise KeyError(f"{cfg.name}: unknown family {cfg.family!r}; have "
                       f"{sorted(SUB_CONFIGS)}")
    missing = [k for k in SUB_CONFIGS[cfg.family]
               if getattr(cfg, k) is None]
    if missing:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs its "
                         f"sub-config {', '.join(f'cfg.{k}' for k in missing)}")
    return cfg.family


# ---------------------------------------------------------------------------
# ssm-family LM (mamba2): thin assembly over ssm.py blocks
# ---------------------------------------------------------------------------

def _ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": layers.norm_specs(cfg.d_model),
            "ssm": ssm.ssm_specs(cfg)}


def _ssm_lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": transformer.embed_spec(cfg),
        "layers": transformer.stack_specs(_ssm_block_specs(cfg),
                                          cfg.n_layers),
        "final_norm": layers.norm_specs(cfg.d_model),
        "lm_head": transformer.head_spec(cfg),
    }


def _ssm_hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                rt: Runtime) -> torch.Tensor:
    """The Mamba2 stack over ``tokens`` (B, S) -> the final-normed hidden
    states (B, S, d), whole (:func:`_ssm_stream`, gathered where the
    sequence splits)."""
    rt = rt.on_sequence(tokens.shape[1], cfg)
    return layers.gather_seq(_ssm_stream(params, cfg, tokens, rt), rt)


def _ssm_stream(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                rt: Runtime) -> torch.Tensor:
    """The Mamba2 stack over ``tokens`` (B, S) -> the final-normed hidden
    states (B, S, d), this rank's rows where ``rt`` (on the sequence)
    splits it.  Pre-norm residual blocks; each ``x = x + y; h =
    norm(x)`` is one fused ``rms_norm_residual``, as in the dense
    decoder: for mamba2-2.7b (64 layers) 65 ``rms_norm`` (the first norm
    and each block's gated norm), 64 ``rms_norm_residual`` and 64
    ``ssd_scan`` calls per forward (on a rank whose heads split, the
    gated norms are ``layers.rms_norm_split``: 1 ``rms_norm``).  Layer i
    (its opening norm and block) is one region of ``rt.checkpoint``, its
    ``"data"`` blocks gathered inside it, as in
    :func:`repro_torch.models.transformer._stack`."""
    specs = _ssm_block_specs(cfg)

    def region(p):
        def run(y, x):
            q = layers.gather_fsdp(p, specs, rt)
            h, x = layers.open_norm(rt, y, x, q["norm"]["scale"],
                                    cfg.norm_eps)
            return x, ssm.mamba_block(q["ssm"], cfg, h, rt)
        return run

    x = transformer.embed(params, cfg, tokens, rt)
    y = None
    for p in transformer.unstack_layers(params["layers"]):
        x, y = rt.checkpoint(region(p))(y, x)
    return layers.open_norm(rt, y, x, params["final_norm"]["scale"],
                            cfg.norm_eps)[0]


def _ssm_decode_step(params: PyTree, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                     position: torch.Tensor, rt: Runtime, valid=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of the Mamba2 LM.  tokens: (B, 1) int; position:
    (B,) int (unused: the state is the sequence so far); cache
    {ssm_state (L, B, H, P, N) float32, conv_state (L, B, W-1, C)},
    updated IN PLACE at the rows where ``valid`` holds (every row for
    ``None``; host rows or a device mask, see
    :mod:`repro_torch.models.masking`).  The norm sites fuse as in
    :func:`_ssm_hidden`: for mamba2-2.7b 65 ``rms_norm`` and 64
    ``rms_norm_residual`` calls a step.  Returns ``(logits (B, V),
    cache)`` — the same cache dict."""
    rows = valid_rows(valid, position.device)
    specs = _ssm_block_specs(cfg)
    x = transformer.embed(params, cfg, tokens, rt)
    per_layer = transformer.unstack_layers(params["layers"])
    h = rt.op("rms_norm")(x, per_layer[0]["norm"]["scale"], cfg.norm_eps)
    for i, p in enumerate(per_layer):
        p = layers.gather_fsdp(p, specs, rt)
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["norm"]["scale"],
                                              cfg.norm_eps)
        y = ssm.mamba_decode_block(p["ssm"], cfg, h, cache["ssm_state"][i],
                                   cache["conv_state"][i], rt, rows)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return transformer.unembed(params, cfg, h, rt)[:, 0], cache


def _ssm_lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
                 rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy of the Mamba2 LM, as
    :func:`repro_torch.models.transformer.lm_loss` for the dense one."""
    tokens = batch["tokens"]
    rt = rt.on_sequence(tokens.shape[1], cfg)
    h = _ssm_stream(params, cfg, tokens, rt)
    mask = batch.get("mask")
    return transformer.next_token_loss(
        params, cfg, h, tokens[:, 1:],
        None if mask is None else mask[:, 1:], rt, slice(None, -1))


# ---------------------------------------------------------------------------
# Arch record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ModelConfig

    def param_specs(self) -> PyTree:
        return param_specs(self.cfg)

    def init_params(self, seed: int, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> PyTree:
        """Random parameters from ``seed`` on ``device`` (the GPU unless
        ``"cpu"`` is named), in ``dtype`` (each spec's own when None;
        float32 specs stay float32)."""
        dev = resolve_device(device)
        specs = layers.map_specs(
            lambda s: dataclasses.replace(s, dtype=s.dtype_for(dtype)),
            self.param_specs())
        return layers.init_tree(specs,
                                torch.Generator(device=dev).manual_seed(seed))

    def loss_fn(self) -> Callable:
        """``loss(params, cfg, batch, rt)`` -> float32 scalar."""
        return {"dense": transformer.lm_loss, "moe": transformer.lm_loss,
                "ssm": _ssm_lm_loss, "hybrid": hybrid.lm_loss,
                "encdec": encdec.seq2seq_loss,
                "vlm": vlm.vlm_loss}[_family(self.cfg)]

    def prefill_fn(self) -> Optional[Callable]:
        """``prefill(params, batch, rt, cache=None)`` -> (last-position
        logits, KV cache); for encdec the encoder, ``(memory, {})``, as
        the reference's; None for the recurrent families, whose prefill
        is their forward (see
        :func:`repro_torch.train.steps.make_serve_step`)."""
        f = _family(self.cfg)
        cfg = self.cfg
        if f in ("dense", "moe"):
            return lambda p, b, rt, cache=None: transformer.prefill(
                p, cfg, b["tokens"], rt, cache)
        if f == "vlm":
            return lambda p, b, rt, cache=None: vlm.prefill(p, cfg, b, rt,
                                                            cache)
        if f == "encdec":
            return lambda p, b, rt, cache=None: (
                encdec.encode(p, cfg, b["frames"], rt), {})
        return None

    def decode_fn(self) -> Callable:
        """``decode(params, cfg, cache, tokens, position, rt, valid=None)``
        -> (logits (B, V), the same cache updated in place)."""
        return {"dense": transformer.decode_step,
                "moe": transformer.decode_step, "vlm": vlm.decode_step,
                "ssm": _ssm_decode_step, "hybrid": hybrid.decode_step,
                "encdec": encdec.decode_step}[_family(self.cfg)]

    def skip_reason(self, shape: ShapeConfig) -> Optional[str]:
        """Why this arch does not run ``shape``'s cell, or None."""
        for name, reason in self.cfg.skip_shapes:
            if name == shape.name:
                return reason
        return None

    def input_specs(self, shape: ShapeConfig, *, batch_override=None
                    ) -> Dict[str, torch.Tensor]:
        return input_specs(self.cfg, shape, batch_override=batch_override)

    def cache_specs(self, shape: ShapeConfig, *, batch_override=None,
                    tp: int = 1) -> PyTree:
        return cache_specs(self.cfg, shape, batch_override=batch_override,
                           tp=tp)


def layout(cfg: ModelConfig, rt: Runtime
           ) -> Optional[Dict[str, layers.Partition]]:
    """:func:`rules_layout` of ``rt``'s rules on its rank mesh; None
    without rules or off a mesh of more than one rank."""
    if rt.rules is None or rt.ranks <= 1:
        return None
    return rules_layout(cfg, rt.rules_(), rt.mesh)


def rules_layout(cfg: ModelConfig, rules: Dict[str, Any], mesh
                 ) -> Optional[Dict[str, layers.Partition]]:
    """``path -> partition`` of every parameter leaf under ``rules`` on
    ``mesh`` (anything with an axis-name -> size ``shape``;
    ``layers.tree_layout``: a leaf mapping one mesh axis to two dims
    raises), or None where the rules split no leaf but the MoE's experts
    and not the sequence (``pure_dp``, ``full_dp``, a mesh whose named
    axes hold one rank each): every such path is the one that runs
    without rules, the experts split by ``moe``.  A layout that splits
    the sequence alone (``ssm_seq`` where the vocabulary does not divide
    the ranks and no ``"data"`` axis splits) comes back, every leaf
    whole.

    The sequence is not a parameter's axis: ``seq_model`` and
    ``megatron_seq`` lay the parameters out as ``baseline`` and
    ``megatron`` do, and ``ssm_seq`` keeps every mixer whole (the
    vocabulary and the experts on ``layers.TP_AXIS``, ``fsdp_embed`` on
    ``"data"``); their ``"seq"`` on ``layers.TP_AXIS`` splits the stream
    where ``layers.seq_form`` says, in Megatron's form or in Mamba's.

    What the port does not run raises ``ValueError``: rules that shard
    the sequence over another axis of more than one rank, or over
    ``layers.TP_AXIS`` with some of the mixers' axes
    (``layers.SEQ_MIXER_AXES``) there and some not, a dim split over
    ``layers.TP_AXIS`` together with another axis, and a Mamba block
    whose leaves do not
    split over ``layers.TP_AXIS`` together (its heads, its columns of
    the projection and of the conv, its norm and ``w_out`` rows: all or
    none) or whose heads split off their groups' edges
    (``ssm.rank_dims``)."""
    out = layers.tree_layout(param_specs(cfg), rules, mesh)
    split = [path for path, part in out.items()
             if any(part) and not moe.is_expert_leaf(path)]
    seq = [a for a in layers.entry_axes(rules.get("seq"))
           if mesh.shape.get(a, 1) > 1]
    if not split and not seq:
        return None
    if seq and seq != [layers.TP_AXIS]:
        raise ValueError(f"the rules shard the sequence over {seq}; the "
                         f"port splits it over {layers.TP_AXIS!r} only")
    mixers = {k: layers.entry_axes(rules.get(k))
              for k in layers.SEQ_MIXER_AXES}
    if seq and set(mixers.values()) not in ({(layers.TP_AXIS,)}, {()}):
        off = [k for k, v in mixers.items() if v != (layers.TP_AXIS,)]
        raise ValueError(f"the rules shard the sequence over {seq} with "
                         f"{off} of the mixers' axes off it and the "
                         "others on it; the port splits the sequence with "
                         "the mixers all on it or all whole")
    for path in split:
        for entry in out[path]:
            axes = layers.entry_axes(entry)
            if layers.TP_AXIS in axes and len(axes) > 1:
                raise ValueError(f"{path}: a dim split over {axes} mixes "
                                 f"{layers.TP_AXIS!r} with other axes")
    if cfg.ssm is not None:
        tp = {path: any(layers.TP_AXIS in layers.entry_axes(e)
                        for e in part)
              for path, part in out.items() if "/ssm/" in path}
        if len(set(tp.values())) > 1:
            raise ValueError(
                f"{cfg.name}: the rules split "
                f"{sorted(p for p, t in tp.items() if t)} of the Mamba "
                f"block over {layers.TP_AXIS!r} and not "
                f"{sorted(p for p, t in tp.items() if not t)}; its heads "
                "and columns split together or not at all")
        if any(tp.values()):
            ssm.rank_dims(cfg, mesh.shape[layers.TP_AXIS])
    return out


# the logical axes of the heads: where the layout splits one of them the
# decode state is a rank's part (``cache_specs`` with ``tp``)
HEAD_AXES = ("heads", "kv_heads", "ssm_heads", "ssm_inner")


def tp_ways(cfg: ModelConfig, rt: Runtime) -> int:
    """The ranks that tensor parallelism splits ``cfg``'s heads over
    under ``rt`` (the size of its ``layers.TP_AXIS`` where its
    :func:`layout` splits a leaf's heads there: :data:`HEAD_AXES`),
    else 1: what sizes a rank's decode state (:func:`cache_specs`).
    Under ``ssm_seq`` only the vocabulary and the experts split, and the
    decode state is the whole one."""
    axis = rt.tp_axis()
    laid = None if axis is None else layout(cfg, rt)
    if laid is None:
        return 1
    for path, spec in layers.spec_paths(param_specs(cfg)):
        if any(name in HEAD_AXES and
               layers.TP_AXIS in layers.entry_axes(entry)
               for name, entry in zip(spec.axes, laid[path])):
            return axis.size
    return 1


def param_specs(cfg: ModelConfig) -> PyTree:
    f = _family(cfg)
    if f == "ssm":
        return _ssm_lm_specs(cfg)
    if f == "hybrid":
        return hybrid.hybrid_specs(cfg)
    if f == "encdec":
        return encdec.encdec_specs(cfg)
    if f == "vlm":
        return vlm.vlm_specs(cfg)
    return transformer.lm_specs(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Every input of ``shape``'s step as a ``meta`` tensor (shape and
    dtype, no storage): decode ``tokens (B, 1)``; encdec ``frames (B,
    S/2, d)`` and ``tokens (B, S/2)``; vlm ``patches (B, n_p,
    vision_dim)`` and ``tokens (B, S - n_p)``; otherwise ``tokens (B,
    S)``.  Token ids are int32, the stubbed frontends' embeddings
    bfloat16, as the reference's."""
    f = _family(cfg)
    b = batch_override if batch_override is not None else shape.global_batch
    s = shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta((b, 1), torch.int32)}
    if f == "encdec":
        half = s // 2
        return {"frames": meta((b, half, cfg.d_model), layers.DEFAULT_DTYPE),
                "tokens": meta((b, half), torch.int32)}
    if f == "vlm":
        n_p = cfg.vlm.n_patches
        return {"patches": meta((b, n_p, cfg.vlm.vision_dim),
                                layers.DEFAULT_DTYPE),
                "tokens": meta((b, s - n_p), torch.int32)}
    return {"tokens": meta((b, s), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None,
                tp: int = 1) -> PyTree:
    """Decode-state ParamSpec tree sized for ``shape`` (cache of
    ``seq_len``; the encdec's cross cache of ``seq_len`` source
    positions too, as the reference's).  With ``tp`` (:func:`tp_ways`)
    a rank's under tensor parallelism: its kv heads
    (``attention.kv_heads_split``), its ssm heads and conv channels
    (``ssm.ssm_cache_specs``)."""
    f = _family(cfg)
    b = batch_override if batch_override is not None else shape.global_batch
    if f == "ssm":
        return ssm.ssm_cache_specs(cfg, b, tp=tp)
    if f == "hybrid":
        return hybrid.cache_specs(cfg, b, shape.seq_len, tp)
    if f == "encdec":
        return encdec.cache_specs(cfg, b, shape.seq_len,
                                  src_len=shape.seq_len, tp=tp)
    return attention.kv_cache_specs(cfg, b, shape.seq_len,
                                    kv_heads=attention.kv_heads_split(cfg,
                                                                      tp))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, build: Callable[[], ModelConfig]):
    _REGISTRY[name] = build


def get(name: str) -> Arch:
    _ensure_configs_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return Arch(cfg=_REGISTRY[name]())


def names() -> Tuple[str, ...]:
    _ensure_configs_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_configs_loaded():
    import repro_torch.configs  # noqa: F401  (registers the archs)
