"""Carry parameters and caches across from host arrays.

The JAX package keeps parameters as a nested dict of arrays with the
same keys and shapes as the port's (:func:`repro_torch.models.registry.
param_specs`).  Given that tree as numpy arrays — a bfloat16 leaf goes
through ``np.array(x, np.float32)``, which is exact, since
``torch.from_numpy`` cannot read ``ml_dtypes.bfloat16`` — these
functions build the port's tree of tensors on a device.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import layers, registry
from repro_torch.models.config import ModelConfig, ShapeConfig

PyTree = Any


def _leaf(spec: layers.ParamSpec, x, device: torch.device,
          dtype: Optional[torch.dtype], what: str) -> torch.Tensor:
    # a fresh, writable copy: the tree's arrays never alias the port's
    # tensors (a cache is written in place)
    arr = np.array(x, np.float32)
    if tuple(arr.shape) != spec.shape:
        raise ValueError(f"{what}: shape {tuple(arr.shape)}, expected "
                         f"{spec.shape}")
    return torch.from_numpy(arr).to(device=device,
                                    dtype=spec.dtype_for(dtype))


def _convert(specs: PyTree, tree: Mapping, device, dtype, what) -> PyTree:
    missing = set(specs) - set(tree)
    extra = set(tree) - set(specs)
    if missing or extra:
        raise ValueError(f"{what}: keys differ (missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)})")
    return {k: (_leaf(s, tree[k], device, dtype, f"{what}.{k}")
                if isinstance(s, layers.ParamSpec)
                else _convert(s, tree[k], device, dtype, f"{what}.{k}"))
            for k, s in specs.items()}


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> PyTree:
    """The port's parameter tree for ``cfg`` from a same-keyed tree of
    host arrays, on ``device`` (the GPU unless ``"cpu"`` is named), in
    ``dtype`` (each spec's own dtype when None; a float32 spec stays
    float32).  Keys and shapes are checked against the port's specs."""
    return _convert(registry.param_specs(cfg), tree, resolve_device(device),
                    dtype, "params")


def cache_from_numpy(tree: Mapping, cfg: ModelConfig, batch: int,
                     max_len: int, device: DeviceLike = None,
                     dtype: Optional[torch.dtype] = None) -> PyTree:
    """The decode state of ``cfg``'s family for ``batch`` rows and
    ``max_len`` positions (:func:`repro_torch.models.registry.
    cache_specs`: a KV cache {k, v: (L, B, S_max, Hkv, D)}, the ssm
    family's {ssm_state, conv_state}, the hybrid's all four) from host
    arrays, as :func:`params_from_numpy` does for parameters (a float32
    spec, the ``ssm_state``, stays float32)."""
    shape = ShapeConfig("cache", max_len, batch, "decode")
    return _convert(registry.cache_specs(cfg, shape), tree,
                    resolve_device(device), dtype, "cache")
