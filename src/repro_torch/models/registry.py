"""Architecture registry: an architecture name resolves here.

For every architecture this module answers ``param_specs(cfg)`` (the full
parameter tree of ParamSpec leaves), ``decode_fn()`` (the serving decode
step) and ``cache_specs(cfg, shape)`` (the decode-state tree).  The port
serves the ``dense`` family; the others raise, naming the slice that
brings them.  The configs live in :mod:`repro_torch.configs`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.models import attention, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ModelConfig

    def param_specs(self) -> PyTree:
        return param_specs(self.cfg)

    def decode_fn(self) -> Callable:
        transformer._dense_only(self.cfg)
        return transformer.decode_step

    def cache_specs(self, shape: ShapeConfig, *, batch_override=None
                    ) -> PyTree:
        return cache_specs(self.cfg, shape, batch_override=batch_override)


def param_specs(cfg: ModelConfig) -> PyTree:
    return transformer.lm_specs(cfg)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None) -> PyTree:
    """Decode-state ParamSpec tree sized for ``shape`` (cache of
    ``seq_len``)."""
    transformer._dense_only(cfg)
    b = batch_override if batch_override is not None else shape.global_batch
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
