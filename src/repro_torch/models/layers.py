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

The rules map the logical axes onto mesh axes (:func:`spec_to_pspec`).
:func:`tree_layout` lays out a whole tree and refuses a leaf that maps
one mesh axis to two of its dims, as the reference's ``NamedSharding``
does; :func:`shard_params` cuts a tree to this rank's blocks of that
layout and :func:`gather_params` joins them again.  A block split over
:data:`TP_AXIS` is computed on where it lies (tensor parallelism: the
column- and row-parallel halves of :func:`swiglu`, :func:`row_parallel`,
the vocabulary-parallel :func:`cross_entropy_loss`); a block split over
any other axis (FSDP's ``"data"``) is gathered before use
(:func:`gather_fsdp`).

Sequence parallelism (the ``seq_model`` and ``megatron_seq`` presets,
Megatron's form): where :func:`seq_axis` splits a call's sequence, each
rank holds its S / tp rows of the (B, S, d) stream between the mixers
(attention, the SwiGLU, the MoE, the Mamba block), and the norm sites
run on them (:func:`open_norm`).  A mixer's input enters through
:func:`enter` (the rows gathered over the axis) and its output leaves
through :func:`row_parallel` (its float32 partial sums reduce-scattered
over the sequence, or where the mixer runs whole on every rank, the
rank's rows taken).  Under ``ssm_seq`` (Mamba's form, :func:`seq_form`
``"rows"``) every mixer is whole: the attention still reads the
gathered sequence, while the row-wise mixers (the SwiGLU with
``rows``, the Mamba block) run on the rank's rows with no collective;
every whole leaf a site applies to the rows enters through
:func:`on_rows` (``ranks.copy_to``: its gradient summed over the ranks),
a leaf applied to the gathered sequence does not (each rank's gradient
of it is already the whole one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.core import ranks
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


def spec_paths(specs: PyTree, prefix: str = ""
               ) -> Iterator[Tuple[str, ParamSpec]]:
    """``(path, spec)`` for every ParamSpec, ``/``-joined keys in
    sorted-key order (the paths of :func:`repro_torch.tree.paths`)."""
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from spec_paths(specs[k], f"{prefix}/{k}" if prefix else k)


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
# the mesh axis of tensor parallelism (the rules' "heads", "kv_heads",
# "mlp", "vocab" and "experts"); a leaf's block over any other axis is
# gathered before use
TP_AXIS = "model"
# the logical axes the mixers split over: the sequence splits over
# TP_AXIS only where they all split there too (Megatron's sequence
# parallelism) or none does (ssm_seq's), :func:`seq_form`
SEQ_MIXER_AXES = ("heads", "kv_heads", "mlp", "ssm_inner", "ssm_heads")


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition entry (none for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


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


def check_partition(path: str, partition: Partition) -> None:
    """Refuse a partition that maps one mesh axis to two dims of the
    leaf at ``path`` (``ValueError`` naming both), as the reference's
    ``NamedSharding`` refuses it (``DuplicateSpecError``)."""
    seen: Dict[str, int] = {}
    for dim, entry in enumerate(partition):
        for axis in entry_axes(entry):
            if axis in seen:
                raise ValueError(
                    f"{path}: the layout maps mesh axis {axis!r} to dims "
                    f"{seen[axis]} and {dim} {partition}; a mesh axis "
                    "shards at most one dim of a leaf")
            seen[axis] = dim


def tree_layout(specs: PyTree, rules: Dict[str, Any],
                mesh) -> Dict[str, Partition]:
    """``path -> partition`` of every leaf of ``specs`` under ``rules`` on
    ``mesh``, each checked by :func:`check_partition`."""
    out = {}
    for path, spec in spec_paths(specs):
        out[path] = spec_to_pspec(spec, rules, mesh)
        check_partition(path, out[path])
    return out


def _partition_at(layout: Dict[str, Partition], path: str, leaf
                  ) -> Optional[Partition]:
    """The partition of the layout's leaf that ``path`` ends with (a
    tree nesting parameter trees, such as the AdamW state or a
    checkpoint's, holds them under longer paths), or None."""
    parts = path.split("/")
    for i in range(len(parts)):
        part = layout.get("/".join(parts[i:]))
        if part is not None and isinstance(leaf, torch.Tensor) and \
                leaf.dim() == len(part):
            return part
    return None


def shard_params(tree: PyTree, specs: PyTree, rules: Dict[str, Any],
                 mesh) -> PyTree:
    """This rank's block of every leaf of ``tree`` (the parameters, or a
    tree nesting them) under ``rules`` on the rank mesh ``mesh``: each
    split dim cut to the rank's index on its axes, as a contiguous copy;
    a leaf the layout keeps whole is the same tensor.  The port's
    counterpart of placing the parameters by the reference's
    ``tree_shardings``."""
    layout = tree_layout(specs, rules, mesh)

    def cut(path: str, leaf):
        part = _partition_at(layout, path, leaf)
        if part is None or not any(part):
            return leaf
        for dim, entry in enumerate(part):
            if entry is not None:
                axis = mesh.axis(entry)
                n = leaf.shape[dim] // axis.size
                leaf = leaf.narrow(dim, axis.index * n, n)
        return leaf.contiguous()

    return tree_util.unflatten(tree, [cut(path, leaf) for path, leaf
                                      in tree_util.paths(tree)])


def gather_params(tree: PyTree, specs: PyTree, rules: Dict[str, Any],
                  mesh) -> PyTree:
    """The inverse of :func:`shard_params` across ranks (every rank of
    the mesh calls it): each split dim gathered over its axes, the whole
    tree on every rank, bit for bit."""
    layout = tree_layout(specs, rules, mesh)

    def join(path: str, leaf):
        part = _partition_at(layout, path, leaf)
        for dim, entry in enumerate(part or ()):
            if entry is not None:
                leaf = ranks.all_gather(leaf, mesh.axis(entry), dim)
        return leaf

    return tree_util.unflatten(tree, [join(path, leaf) for path, leaf
                                      in tree_util.paths(tree)])


def whole_like(tree: PyTree, specs: PyTree, rules: Dict[str, Any],
               mesh) -> PyTree:
    """Empty tensors of the whole tree's shapes, from this rank's blocks
    of it (a template to restore a checkpoint into)."""
    layout = tree_layout(specs, rules, mesh)

    def grow(path: str, leaf):
        shape = list(leaf.shape)
        for dim, entry in enumerate(_partition_at(layout, path, leaf) or ()):
            if entry is not None:
                shape[dim] *= mesh.axis(entry).size
        return torch.empty(shape, dtype=leaf.dtype, device=leaf.device)

    return tree_util.unflatten(tree, [grow(path, leaf) for path, leaf
                                      in tree_util.paths(tree)])


def split_axis(here: int, whole: int, rt, what: str
               ) -> Optional[ranks.Axis]:
    """The tensor-parallel axis (``rt.tp_axis()``) when a dim holds
    ``here`` of its ``whole`` entries on this rank, else None; a split
    dim on a runtime without that axis raises."""
    if here == whole:
        return None
    axis = None if rt is None else rt.tp_axis()
    if axis is None:
        raise ValueError(f"{what} holds {here} of {whole} entries on a "
                         "runtime without a tensor-parallel axis")
    return axis


def gather_fsdp(tree: PyTree, specs: PyTree, rt) -> PyTree:
    """``tree`` (one layer's parameters, or the embedding) with every
    dim that ``rt``'s rules split over an axis other than
    :data:`TP_AXIS` and that this rank holds a block of gathered whole
    (:func:`repro_torch.core.ranks.gather_from`: the backward
    reduce-scatters the gradient).  A leaf may carry leading dims its
    spec lacks (the stacked layers).  ``tree`` itself off a laid-out
    runtime."""
    if rt.rules is None or rt.ranks <= 1:
        return tree
    rules, mesh = rt.rules_(), rt.mesh

    def one(spec: ParamSpec, leaf: torch.Tensor) -> torch.Tensor:
        lead = leaf.dim() - len(spec.shape)
        for dim, entry in enumerate(spec_to_pspec(spec, rules, mesh)):
            axes = tuple(a for a in entry_axes(entry) if a != TP_AXIS)
            if axes and leaf.shape[lead + dim] != spec.shape[dim]:
                leaf = ranks.gather_from(leaf, mesh.axis(axes), lead + dim)
        return leaf

    if isinstance(specs, ParamSpec):
        return one(specs, tree)
    return {k: gather_fsdp(tree[k], specs[k], rt) if k in specs else tree[k]
            for k in tree}


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

def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim in :func:`compute` precision (the
    population variance), scaled and shifted, in ``x``'s dtype."""
    xc = compute(x)
    mu = xc.mean(-1, keepdim=True)
    var = xc.var(-1, unbiased=False, keepdim=True)
    out = (xc - mu) * torch.rsqrt(var + eps)
    return (out * compute(weight) + compute(bias)).to(x.dtype)


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


def seq_form(rt, s: int, cfg=None) -> Optional[str]:
    """How a call over a sequence of ``s`` positions splits it over
    :data:`TP_AXIS` (``rt.tp_axis()``, more than one rank, ``s``
    dividing over them) where ``rt``'s rules map ``"seq"`` there:

    * ``"mixers"`` (``seq_model``, ``megatron_seq``: Megatron's form)
      where the mixers' axes (:data:`SEQ_MIXER_AXES`) all split there
      too: each mixer runs between a gather of the rows and a
      reduce-scatter of its output;
    * ``"rows"`` (``ssm_seq``: Mamba's form) where they are all whole:
      the row-wise mixers (the SwiGLU, the Mamba block) run on the
      rank's rows with their whole weights, the attention over the
      gathered sequence.  A ``cfg`` with Mamba blocks splits so only
      where ``s / tp`` is a multiple of its chunk and holds the conv's
      ``d_conv - 1`` rows of halo.

    None otherwise (the reference's fallback: a dim that does not divide
    stays whole), and the call runs the base preset's path.  A decode
    step (``s`` 1) never splits."""
    axis = None if rt is None else rt.tp_axis()
    if axis is None or s % axis.size:
        return None
    table = rt.rules_()
    if entry_axes(table.get("seq")) != (TP_AXIS,):
        return None
    mixers = {entry_axes(table.get(k)) for k in SEQ_MIXER_AXES}
    if mixers == {(TP_AXIS,)}:
        return "mixers"
    if mixers != {()}:
        return None
    here = s // axis.size
    ssm = None if cfg is None else cfg.ssm
    if ssm is not None and (here % ssm.chunk or here < ssm.conv_width - 1):
        return None
    return "rows"


def seq_axis(rt, s: int, cfg=None) -> Optional[ranks.Axis]:
    """The axis a call over a sequence of ``s`` positions splits it over
    (:data:`TP_AXIS`) where :func:`seq_form` splits it, else None."""
    return None if seq_form(rt, s, cfg) is None else rt.tp_axis()


def enter(x: torch.Tensor, axis: Optional[ranks.Axis],
          seq: Optional[ranks.Axis]) -> torch.Tensor:
    """A mixer's input: ``x`` (the normed stream, this rank's rows of the
    sequence where ``seq`` splits it) as the mixer reads it.  With
    ``axis`` the mixer holds this rank's part (its heads, columns):
    ``x`` enters through ``copy_to``, or over a split sequence through
    ``gather_from`` (the backward reduce-scatters the ranks' partial
    cotangents).  Without it the mixer runs whole on every rank: ``x``
    itself, or over a split sequence ``gather_whole``."""
    if seq is None:
        return x if axis is None else ranks.copy_to(x, axis)
    if axis is None:
        return ranks.gather_whole(x, seq, 1)
    return ranks.gather_from(x, seq, 1)


def stream_len(x: torch.Tensor, rt) -> int:
    """The positions of the whole sequence of the stream ``x`` (B, S,
    ...): S, times the ranks where ``rt.seq_axis()`` splits it."""
    seq = rt.seq_axis()
    return x.shape[1] * (1 if seq is None else seq.size)


def gather_seq(x: torch.Tensor, rt) -> torch.Tensor:
    """The whole sequence of a stream of which this rank holds its rows
    where ``rt.seq_axis()`` splits it (``gather_whole``), for what every
    rank then reads whole; ``x`` itself otherwise."""
    seq = rt.seq_axis()
    return x if seq is None else ranks.gather_whole(x, seq, 1)


def split_seq(x: torch.Tensor, rt) -> torch.Tensor:
    """This rank's rows of a stream every rank holds whole, where
    ``rt.seq_axis()`` splits the sequence (``split_to``); ``x`` itself
    otherwise."""
    seq = rt.seq_axis()
    return x if seq is None else ranks.split_to(x, seq, 1)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 axis: Optional[ranks.Axis] = None,
                 seq: Optional[ranks.Axis] = None) -> torch.Tensor:
    """``x @ w``, a mixer's output; with ``axis``, ``w`` is this rank's
    rows and ``x`` its matching columns, and the ranks' partial products
    are summed over the axis in float32 and rounded once (a bfloat16 sum
    of bfloat16 parts would round at every rank's part).  With ``seq``
    (``x`` over the whole sequence, :func:`enter`) the sum is
    reduce-scattered over the sequence, each rank keeping its rows
    (``reduce_scatter_to``), or without ``axis`` the product's rows of
    this rank taken (``split_to``)."""
    if axis is None:
        y = x @ w
        return y if seq is None else ranks.split_to(y, seq, 1)
    part = compute(x) @ compute(w)
    if seq is None:
        return ranks.reduce_from(part, axis).to(x.dtype)
    return ranks.reduce_scatter_to(part, seq, 1).to(x.dtype)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   axis: ranks.Axis, width: int) -> torch.Tensor:
    """RMSNorm over a last dim of ``width`` entries of which ``x`` holds
    this rank's columns and ``scale`` their scales: each row's float32
    sum of squares is summed over ``axis`` (a (..., 1) all-reduce where
    gathering the rows would move all of them), then the rank's columns
    are normalised.  Each rank's columns read the sum, so its backward
    sums the ranks' cotangents of it as well."""
    xf = compute(x)
    ss = ranks.reduce_from(ranks.copy_to(xf.square().sum(-1, keepdim=True),
                                         axis), axis)
    return (xf * torch.rsqrt(ss / width + eps) * compute(scale)).to(x.dtype)


def on_rows(w: torch.Tensor, seq: Optional[ranks.Axis]) -> torch.Tensor:
    """A whole leaf ``w`` that a site applies to this rank's rows of a
    sequence split over ``seq``: it enters through ``copy_to``, so that
    its gradient from the rank's rows is summed over the ranks; ``w``
    itself where the sequence is whole."""
    return w if seq is None else ranks.copy_to(w, seq)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, axis: Optional[ranks.Axis] = None,
           seq: Optional[ranks.Axis] = None,
           rows: bool = False) -> torch.Tensor:
    """The SwiGLU FFN; with ``axis`` the rank's columns of ``w_gate`` and
    ``w_up`` and rows of ``w_down`` (tensor parallelism).  ``x`` enters
    and the output leaves as :func:`enter` and :func:`row_parallel` say
    (``seq``: ``x`` is this rank's rows of the sequence).  Over a split
    sequence the hidden columns stay split by ``"mlp"`` on the gathered
    rows, where the reference's ``constrain`` lets ``"seq"`` take the
    axis; the values are the same.  With ``rows`` (``ssm_seq``'s form,
    ``Runtime.seq_rows``) the whole weights run on the rank's rows with
    no collective, each entering through :func:`on_rows`."""
    if rows and seq is not None:
        w_gate, w_up, w_down = (on_rows(w, seq)
                                for w in (w_gate, w_up, w_down))
        seq = None
    x = enter(x, axis, seq)
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(compute(g)).to(x.dtype) * u
    return row_parallel(h, w_down, axis, seq)


def open_norm(rt, y: Optional[torch.Tensor], x: torch.Tensor,
              scale: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stack's norm site ``x = x + y; h = norm(x)`` -> ``(h, x)``: one
    fused ``rms_norm_residual`` through ``rt``'s sites, or ``rms_norm``
    of x alone at the stack's first site (``y`` None).  Every
    checkpointed region of a layer walk opens with it, so a region's
    inputs are ``(y, x)``.  Where ``rt.seq_axis()`` splits the sequence
    the site runs on this rank's rows, and the whole ``scale`` enters
    through ``copy_to``: its gradient from the rank's rows is summed over
    the ranks."""
    scale = on_rows(scale, rt.seq_axis())
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
                       z_coef: float = 1e-4,
                       vocab_axis: Optional[ranks.Axis] = None
                       ) -> torch.Tensor:
    """Token-mean next-token cross entropy with the z-loss
    ``z_coef * logsumexp^2``, accumulated in float32 (float64 for
    float64 logits); logits (..., V),
    labels (...) int, ``mask`` (...) marks the positions that count.

    With ``vocab_axis`` the logits are this rank's columns [i V, (i + 1)
    V) of the vocabulary: the row max is taken over the axis (detached:
    the logsumexp does not depend on it), and the sum of exponentials
    and the gold logit are each summed over it."""
    logits = compute(logits)
    if vocab_axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        top = ranks.axis_max(logits.detach().amax(-1), vocab_axis)
        total = torch.exp(logits - top[..., None]).sum(-1)
        lse = torch.log(ranks.reduce_from(total, vocab_axis)) + top
        local = labels.long() - vocab_axis.index * n
        inside = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1,
                            local.clamp(0, n - 1)[..., None])[..., 0]
        gold = ranks.reduce_from(torch.where(inside, gold, 0.0),
                                 vocab_axis)
    loss = lse - gold + z_coef * lse.square()
    if mask is not None:
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)
    return loss.mean()
