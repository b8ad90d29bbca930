"""Architecture registry: an architecture name resolves here.

For every architecture this module answers ``param_specs(cfg)`` (the full
parameter tree of ParamSpec leaves), ``loss_fn()`` (the full-sequence
forward and its loss), ``prefill_fn()`` and ``decode_fn()`` (the serving
entry points) and ``cache_specs(cfg, shape)`` (the decode-state tree).
The port runs three families end to end: ``dense``
(:mod:`~repro_torch.models.transformer`), ``ssm`` (Mamba2, assembled
here over :mod:`~repro_torch.models.ssm`) and ``hybrid`` (Zamba2,
:mod:`~repro_torch.models.hybrid`).  The other families raise
``NotImplementedError`` naming the ROADMAP item that brings them.  The
configs live in :mod:`repro_torch.configs`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import attention, hybrid, layers, ssm, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.masking import valid_rows
from repro_torch.models.runtime import Runtime

PyTree = Any


def _family(cfg: ModelConfig) -> str:
    """``dense``, ``ssm`` or ``hybrid``; any other family raises."""
    if cfg.family == "ssm" and cfg.ssm is not None:
        return "ssm"
    if cfg.family == "hybrid" and cfg.hybrid is not None \
            and cfg.ssm is not None:
        return "hybrid"
    transformer._dense_only(cfg)
    return "dense"


# ---------------------------------------------------------------------------
# ssm-family LM (mamba2): thin assembly over ssm.py blocks
# ---------------------------------------------------------------------------

def _ssm_lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    block = {"norm": layers.norm_specs(cfg.d_model),
             "ssm": ssm.ssm_specs(cfg)}
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                           ("vocab", "fsdp_embed")),
        "layers": layers.map_specs(lambda s: s.stack_layers(cfg.n_layers),
                                   block),
        "final_norm": layers.norm_specs(cfg.d_model),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size),
                             ("fsdp_embed", "vocab")),
    }


def _ssm_hidden(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                rt: Runtime) -> torch.Tensor:
    """The Mamba2 stack over ``tokens`` (B, S) -> the final-normed hidden
    states (B, S, d).  Pre-norm residual blocks; each ``x = x + y; h =
    norm(x)`` is one fused ``rms_norm_residual``, as in the dense
    decoder: for mamba2-2.7b (64 layers) 65 ``rms_norm`` (the first norm
    and each block's gated norm), 64 ``rms_norm_residual`` and 64
    ``ssd_scan`` calls per forward."""
    x = transformer.embed(params, cfg, tokens)
    per_layer = transformer.unstack_layers(params["layers"])
    h = rt.op("rms_norm")(x, per_layer[0]["norm"]["scale"], cfg.norm_eps)
    for i, p in enumerate(per_layer):
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["norm"]["scale"],
                                              cfg.norm_eps)
        y = ssm.mamba_block(p["ssm"], cfg, h, rt)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return h


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
    x = transformer.embed(params, cfg, tokens)
    per_layer = transformer.unstack_layers(params["layers"])
    h = rt.op("rms_norm")(x, per_layer[0]["norm"]["scale"], cfg.norm_eps)
    for i, p in enumerate(per_layer):
        if i:
            h, x = rt.op("rms_norm_residual")(y, x, p["norm"]["scale"],
                                              cfg.norm_eps)
        y = ssm.mamba_decode_block(p["ssm"], cfg, h, cache["ssm_state"][i],
                                   cache["conv_state"][i], rt, rows)
    h, _ = rt.op("rms_norm_residual")(y, x, params["final_norm"]["scale"],
                                      cfg.norm_eps)
    return (h @ params["lm_head"])[:, 0], cache


def _ssm_lm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
                 rt: Runtime) -> torch.Tensor:
    """Next-token cross entropy of the Mamba2 LM, as
    :func:`repro_torch.models.transformer.lm_loss` for the dense one."""
    tokens = batch["tokens"]
    h = _ssm_hidden(params, cfg, tokens, rt)
    logits = h[:, :-1] @ params["lm_head"]
    mask = batch.get("mask")
    return layers.cross_entropy_loss(
        logits, tokens[:, 1:], None if mask is None else mask[:, 1:])


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
        return {"dense": transformer.lm_loss, "ssm": _ssm_lm_loss,
                "hybrid": hybrid.lm_loss}[_family(self.cfg)]

    def prefill_fn(self) -> Optional[Callable]:
        """``prefill(params, batch, rt, cache=None)`` -> (last-position
        logits, KV cache); None for the recurrent families, whose
        prefill is their forward (see
        :func:`repro_torch.train.steps.make_serve_step`)."""
        if _family(self.cfg) != "dense":
            return None
        cfg = self.cfg
        return lambda p, b, rt, cache=None: transformer.prefill(
            p, cfg, b["tokens"], rt, cache)

    def decode_fn(self) -> Callable:
        """``decode(params, cfg, cache, tokens, position, rt, valid=None)``
        -> (logits (B, V), the same cache updated in place)."""
        return {"dense": transformer.decode_step, "ssm": _ssm_decode_step,
                "hybrid": hybrid.decode_step}[_family(self.cfg)]

    def cache_specs(self, shape: ShapeConfig, *, batch_override=None
                    ) -> PyTree:
        return cache_specs(self.cfg, shape, batch_override=batch_override)


def param_specs(cfg: ModelConfig) -> PyTree:
    f = _family(cfg)
    if f == "ssm":
        return _ssm_lm_specs(cfg)
    if f == "hybrid":
        return hybrid.hybrid_specs(cfg)
    return transformer.lm_specs(cfg)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None) -> PyTree:
    """Decode-state ParamSpec tree sized for ``shape`` (cache of
    ``seq_len``)."""
    f = _family(cfg)
    b = batch_override if batch_override is not None else shape.global_batch
    if f == "ssm":
        return ssm.ssm_cache_specs(cfg, b)
    if f == "hybrid":
        return hybrid.cache_specs(cfg, b, shape.seq_len)
    return attention.kv_cache_specs(cfg, b, shape.seq_len)


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
