"""Op-level analysis of a step traced on the ``meta`` device: the port's
counterpart of ``repro.launch.hloanalysis``.

The reference parses a compiled XLA program's HLO text.  The port has no
HLO: its step is eager PyTorch, so :class:`OpAnalysis` is a
``TorchDispatchMode`` that sees every ATen op of a step run on ``meta``
tensors (shapes and dtypes, no storage, nothing computed) and every
kernel site's launch (:mod:`repro_torch.kernels.meta`), and accumulates:

  * dot FLOPs   ``2 * |out| * K`` for ``mm``, ``bmm``, ``addmm`` and
                ``baddbmm`` (what ``einsum``, ``matmul`` and ``linear``
                lower to), plus each kernel site's own formula;
  * HBM bytes   operand-plus-result bytes of every op that is not a view
                or an allocation, each kernel site counted as one op (an
                eager op reads its operands from and writes its result
                to device memory: nothing is fused);
  * collectives only the gradient reduction that
                :mod:`repro_torch.core.gradsync` performs for
                ``rt.gradsync``, over the data-parallel extent
                (:func:`gradient_reduction`).  The port executes no
                tensor-parallel or FSDP collective, so none is modelled.

The collective wire-bytes model is the reference's (per participating
device, ring):

  all-reduce       2 (g-1)/g * B     (ring reduce-scatter + all-gather)
  all-gather       (g-1) * B         (B = per-device shard posted)
  reduce-scatter   (g-1)/g * B       (B = full per-device operand)

It also tracks the bytes of live ``meta`` tensors the step allocates
(each storage from the op that made it until it is freed) and their
peak: an estimate of the step's temporary memory, which the dry-run
reports as such.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as meta_sites

COLLECTIVES_MODELLED = "gradient reduction"

_aten = torch.ops.aten
# allocations: no bytes move until something writes them
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}
_MM = {_aten.mm.default, _aten.addmm.default}
_BMM = {_aten.bmm.default, _aten.baddbmm.default}


def _wire_factor(kind: str, g: int) -> float:
    return {"all-reduce": 2.0 * (g - 1) / max(g, 1),
            "all-gather": float(g - 1),
            "reduce-scatter": (g - 1) / max(g, 1)}[kind]


@dataclasses.dataclass
class CollectiveStat:
    count: int = 0
    operand_bytes: float = 0.0
    wire_bytes: float = 0.0


@dataclasses.dataclass
class Metrics:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, CollectiveStat] = dataclasses.field(
        default_factory=dict)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.collectives.values())

    @property
    def collective_operand_bytes(self) -> float:
        return sum(s.operand_bytes for s in self.collectives.values())

    @property
    def collective_count(self) -> int:
        return sum(s.count for s in self.collectives.values())

    def to_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_count": self.collective_count,
            "collectives": {
                k: dataclasses.asdict(v)
                for k, v in sorted(self.collectives.items())},
            "collectives_modelled": COLLECTIVES_MODELLED,
        }


def tensor_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensor_leaves(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args, out) -> int:
    """``2 * |out| * K`` of a matrix product op, else 0."""
    if func in _MM:
        a = args[1] if func is _aten.addmm.default else args[0]
        return 2 * out.numel() * a.shape[-1]
    if func in _BMM:
        a = args[1] if func is _aten.baddbmm.default else args[0]
        return 2 * out.numel() * a.shape[-1]
    return 0


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as a: step(...)`` on ``meta`` tensors ->
    ``a.metrics`` (dot FLOPs, HBM bytes, collectives), ``a.kernels``
    (launches, FLOPs and bytes by kernel site), ``a.peak_bytes`` (the
    peak of live allocated bytes) and :meth:`top_hbm_ops`.  Inside
    :meth:`repeat` every op counts ``k`` times."""

    def __init__(self):
        super().__init__()
        self.metrics = Metrics()
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, List[float]] = {}     # name -> [bytes, count]
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._mult = 1

    def __enter__(self):
        meta_sites.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        meta_sites.SINKS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def repeat(self, k: int):
        """Count every op inside ``k`` times (the same program on ``k``
        devices, say)."""
        old, self._mult = self._mult, self._mult * k
        try:
            yield self
        finally:
            self._mult = old

    # -- accounting ------------------------------------------------------

    def _count(self, name: str, nbytes: float, flops: float) -> None:
        k = self._mult
        self.metrics.dot_flops += flops * k
        self.metrics.hbm_bytes += nbytes * k
        rec = self.by_op.setdefault(name, [0.0, 0])
        rec[0] += nbytes * k
        rec[1] += k
        self.n_ops += k

    def _track(self, outs: Sequence[torch.Tensor],
               ins: Sequence[torch.Tensor]) -> None:
        """Start the lifetime of every storage an op allocated (an output
        that aliases no input)."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for o in outs:
            st = o.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _ALLOC:
            if func in _ALLOC:
                self._track(tensor_leaves(out), ())
            return out
        ins, outs = tensor_leaves((args, kwargs)), tensor_leaves(out)
        self._count(func.name(), sum(_nbytes(t) for t in ins + outs),
                    dot_flops(func, args, out))
        self._track(outs, ins)
        return out

    def kernel_op(self, name: str, inputs: Sequence[torch.Tensor],
                  outputs: Sequence[torch.Tensor], flops: int) -> None:
        """One kernel site's launch (from :mod:`repro_torch.kernels.
        meta`): one op of the kernel's FLOPs and its operands' and
        results' bytes."""
        nbytes = sum(_nbytes(t) for t in list(inputs) + list(outputs))
        self._count(f"kernel:{name}", nbytes, flops)
        rec = self.kernels.setdefault(name, {"launches": 0, "dot_flops": 0,
                                             "bytes": 0})
        rec["launches"] += self._mult
        rec["dot_flops"] += flops * self._mult
        rec["bytes"] += nbytes * self._mult

    def collective(self, kind: str, operand_bytes: float, group: int,
                   count: int = 1) -> None:
        """Model ``count`` collectives of ``kind`` over ``group`` devices,
        each posting ``operand_bytes`` a device (ring wire bytes)."""
        s = self.metrics.collectives.setdefault(kind, CollectiveStat())
        s.count += count
        s.operand_bytes += operand_bytes * count
        s.wire_bytes += operand_bytes * count * _wire_factor(kind, group)

    def top_hbm_ops(self, n: int = 20) -> List[Tuple[float, int, str]]:
        """The ``n`` ops (by ATen name, a kernel site as ``kernel:name``)
        that contribute the most HBM bytes: ``[(bytes, count, op), ...]``
        descending — the counterpart of the reference's
        ``top_hbm_instructions``."""
        rows = [(b, int(c), name) for name, (b, c) in self.by_op.items()]
        rows.sort(key=lambda r: -r[0])
        return rows[:n]


def gradient_reduction(analysis: OpAnalysis, grads: Sequence[torch.Tensor],
                       rt, group: int, n_devices: int,
                       bucket_bytes: int) -> None:
    """Model the gradient reduction ``rt.gradsync`` performs on each of
    ``n_devices`` devices, over a data-parallel group of ``group``, for
    ``grads``: one device's gradient blocks (``meta`` tensors).

    * ``gspmd`` and ``spindle_per_tensor``: one all-reduce a leaf (the
      framework's reduction; the per-tensor strawman);
    * ``spindle``: one all-reduce a bucket of
      :func:`repro_torch.core.gradsync.make_plan`;
    * ``spindle_compressed``: a bucket's float32 reduce-scatter, the
      ``quantize`` site on the device's shard, the all-gather of the int8
      shards and their scales, and the ``dequantize`` site on the
      gathered bucket (:func:`~repro_torch.core.gradsync.
      compressed_psum_mean`, per device).

    With ``group`` 1 nothing is reduced."""
    from repro_torch.core import gradsync
    if group <= 1:
        return
    grads = list(grads)
    if rt.gradsync in ("gspmd", "spindle_per_tensor"):
        for g in grads:
            analysis.collective("all-reduce", _nbytes(g), group)
        return
    plan = gradsync.make_plan(grads, target_bytes=bucket_bytes)
    for b in range(plan.n_buckets):
        length = plan.bucket_size(b)
        if rt.gradsync == "spindle":
            itemsize = max(plan.leaf_dtypes[i].itemsize
                           for i in plan.bucket_leaves(b))
            analysis.collective("all-reduce", length * itemsize, group)
            continue
        shard_len = -(-length // group)
        padded = shard_len * group
        analysis.collective("reduce-scatter", padded * 4, group)
        # the int8 shard and its float32 scale
        analysis.collective("all-gather", shard_len + 4, group)
        with analysis.repeat(n_devices):
            rt.op("quantize")(
                torch.empty(shard_len, dtype=torch.float32, device="meta"),
                shard_len)
            rt.op("dequantize")(
                torch.empty(padded, dtype=torch.int8, device="meta"),
                torch.empty(group, dtype=torch.float32, device="meta"),
                shard_len, torch.float32)
