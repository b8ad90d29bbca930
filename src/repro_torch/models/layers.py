"""Building-block layers and parameter specs.

Every parameter is declared as a :class:`ParamSpec` carrying its shape,
its *logical* axis names (``'embed'``, ``'heads'``, ``'batch'``,
``'layers'`` ...) and its dtype.  Parameters are plain nested dicts of
tensors with the reference's keys and shapes, so a parameter tree
carries across (:mod:`repro_torch.models.convert`).

The plain RMSNorm lives with its kernels and is re-exported here as
:func:`rms_norm`; the models reach the kernels through
:class:`repro_torch.models.runtime.Runtime`.  :func:`cross_entropy_loss`
is the loss of the full-sequence forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels.rmsnorm import rms_norm_plain as rms_norm  # noqa: F401
from repro_torch.precision import compute, compute_dtype

PyTree = Any

DEFAULT_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis per dim
    dtype: torch.dtype = DEFAULT_DTYPE
    init: str = "normal"                # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")

    def numel(self) -> int:
        return math.prod(self.shape)

    def dtype_for(self, dtype: Optional[torch.dtype]) -> torch.dtype:
        """The dtype a leaf of this spec takes when ``dtype`` is asked:
        the spec's own when None, and float32 where the spec says float32
        (the ssm's per-head vectors, its ``ssm_state``) whatever is asked,
        as the reference keeps them."""
        if dtype is None or self.dtype == torch.float32:
            return self.dtype
        return dtype

    def stack_layers(self, n: int) -> "ParamSpec":
        return ParamSpec((n,) + self.shape, ("layers",) + self.axes,
                         self.dtype, self.init)


def map_specs(fn, specs: PyTree, *rest: PyTree) -> PyTree:
    """``fn(spec, *leaves)`` over a nested dict of ParamSpecs and
    same-keyed trees, keys visited in sorted order (the reference's
    pytree order)."""
    if isinstance(specs, ParamSpec):
        return fn(specs, *rest)
    return {k: map_specs(fn, specs[k], *(r[k] for r in rest))
            for k in sorted(specs)}


def spec_leaves(specs: PyTree) -> Iterator[ParamSpec]:
    """Every ParamSpec of a nested dict, in sorted-key order."""
    if isinstance(specs, ParamSpec):
        yield specs
        return
    for k in sorted(specs):
        yield from spec_leaves(specs[k])


def initialize(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """Materialize one parameter on the generator's device.

    fan_in = product of all non-output dims, excluding stacked 'layers'
    axes (the last dim is treated as the output); weights are
    ``N(0, 1/fan_in)`` drawn in float32 and cast to the spec's dtype."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    fan_in = 1
    for dim, axis in list(zip(spec.shape, spec.axes))[:-1]:
        if axis != "layers":
            fan_in *= dim
    fan_in = fan_in if fan_in > 1 else (spec.shape[-1] or 1)
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return w.mul_(scale).to(spec.dtype)


def init_tree(specs: PyTree, generator: torch.Generator) -> PyTree:
    """Every leaf of ``specs`` initialized from ``generator`` in
    sorted-key order (random weights from a seed)."""
    return map_specs(lambda s: initialize(s, generator), specs)


def abstract_tree(specs: PyTree) -> PyTree:
    """Every leaf of ``specs`` as a ``meta`` tensor of its shape and
    dtype: the stand-in the dry-run traces with (no storage)."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rules
# ---------------------------------------------------------------------------

# The baseline rules (the reference's; the presets of
# :mod:`repro_torch.train.rules` edit them).  Values may be a mesh axis
# name, a tuple of mesh axes, or None (replicated).
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "fsdp_embed": "data",       # FSDP-sharded input dim of big matmuls
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
}

Partition = Tuple[Any, ...]     # per dim: an axis name, a tuple, or None


def _axes_size(axes: Tuple[str, ...], mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def spec_to_pspec(spec: ParamSpec, rules: Dict[str, Any], mesh) -> Partition:
    """The partition of one parameter under ``rules`` on ``mesh``
    (anything with an axis-name -> size ``shape`` mapping): one entry a
    dim, a mesh-axis name, a tuple of names, or None.  A dim whose size
    does not divide its mesh axes is replicated instead (correct, just
    less sharded), as the reference's."""
    out = []
    for dim, name in zip(spec.shape, spec.axes):
        target = rules.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        axes = target if isinstance(target, tuple) else (target,)
        axes = tuple(a for a in axes if a in mesh.shape)
        size = _axes_size(axes, mesh) if axes else 1
        if size <= 1 or dim % size != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def tree_pspecs(specs: PyTree, rules: Dict[str, Any], mesh) -> PyTree:
    return map_specs(lambda s: spec_to_pspec(s, rules, mesh), specs)


def partition_shape(shape: Tuple[int, ...], partition: Partition,
                    mesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` tensor under ``partition``."""
    out = []
    for dim, entry in zip(shape, partition):
        if entry is None:
            out.append(dim)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        out.append(dim // _axes_size(axes, mesh))
    return tuple(out)


def shard_shape(spec: ParamSpec, rules: Dict[str, Any],
                mesh) -> Tuple[int, ...]:
    """The per-device block of one parameter under ``rules``."""
    return partition_shape(spec.shape, spec_to_pspec(spec, rules, mesh),
                           mesh)


def shard_bytes(spec: ParamSpec, rules: Dict[str, Any], mesh,
                dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of one parameter's per-device block, in ``dtype`` (the
    spec's own when None)."""
    itemsize = torch.empty((), dtype=dtype or spec.dtype).element_size()
    return math.prod(shard_shape(spec, rules, mesh)) * itemsize


def tree_shard_bytes(specs: PyTree, rules: Dict[str, Any], mesh,
                     dtype: Optional[torch.dtype] = None) -> int:
    """Per-device bytes of a whole spec tree under ``rules``."""
    return sum(shard_bytes(s, rules, mesh, dtype)
               for s in spec_leaves(specs))


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=dtype,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of the rotation angles, (..., S, 1, D/2) in ``dtype``
    (float32, or float64 for the float64 yardstick), for positions
    (..., S)."""
    freqs = rope_freqs(head_dim, theta, positions.device, dtype)
    angles = positions[..., None].to(dtype) * freqs        # (..., S, D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """The split-half rotation of :func:`apply_rope` with precomputed
    cos/sin, in float32 (float64 for float64) and cast back."""
    x1, x2 = compute(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of the head dimension (not interleaved pairs)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta,
                                   compute_dtype(x.dtype)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(compute(g)).to(x.dtype) * u
    return h @ w_down


def open_norm(rt, y: Optional[torch.Tensor], x: torch.Tensor,
              scale: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stack's norm site ``x = x + y; h = norm(x)`` -> ``(h, x)``: one
    fused ``rms_norm_residual`` through ``rt``'s sites, or ``rms_norm``
    of x alone at the stack's first site (``y`` None).  Every
    checkpointed region of a layer walk opens with it, so a region's
    inputs are ``(y, x)``."""
    if y is None:
        return rt.op("rms_norm")(x, scale, eps), x
    return rt.op("rms_norm_residual")(y, x, scale, eps)


def mlp_specs(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("fsdp_embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("fsdp_embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "fsdp_embed")),
    }


def norm_specs(d_model: int, ln: bool = False) -> Dict[str, ParamSpec]:
    out = {"scale": ParamSpec((d_model,), ("embed",), init="ones")}
    if ln:
        out["bias"] = ParamSpec((d_model,), ("embed",), init="zeros")
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_coef: float = 1e-4) -> torch.Tensor:
    """Token-mean next-token cross entropy with the z-loss
    ``z_coef * logsumexp^2``, accumulated in float32 (float64 for
    float64 logits); logits (..., V),
    labels (...) int, ``mask`` (...) marks the positions that count."""
    logits = compute(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold + z_coef * lse.square()
    if mask is not None:
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)
    return loss.mean()
