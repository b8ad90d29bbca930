"""Runtime context: which implementation the kernel sites use, what a
backward pass recomputes, and how a train step reduces its gradients.

The reference threads a ``Runtime`` (mesh, sharding rules, ``attn_impl``,
``gradsync``) through every forward function and train step.  One device
serves here, so what is left is the switch between the hand-written
kernels and their plain versions:

* ``kernels="kernels"`` (the default) calls the wrappers of
  :mod:`repro_torch.kernels.ops`: on CUDA tensors they launch the Hopper
  kernels (or raise), on CPU tensors they run the plain versions;
* ``kernels="plain"`` calls the plain versions on any device — the
  comparison runs of ``chip_smoke.py`` ask for it explicitly.

the reference's rematerialisation policy, which every family's layer
walk applies to its regions through :meth:`Runtime.checkpoint`:

* ``remat="none"`` (the default) keeps every activation for the
  backward;
* ``remat="full"`` keeps a region's inputs and outputs only and reruns
  its forward in the backward (``jax.checkpoint``);
* ``remat="dots"`` keeps the matrix products' outputs as well and reruns
  the rest (``jax.checkpoint_policies.checkpoint_dots``).  The kernel
  sites are not products, so they rerun under both policies.

The reference defaults to ``full``; the port to ``none``, since every
shape it trains fits on one card without it and remat changes no value,
only memory against time.  The rerun stops once the last tensor the
backward needs is recovered, so a region's trailing work after its last
saved tensor runs once.  :func:`recomputing` tells an observer of the
layer bodies (a router's statistics, say) that a call is a rerun, so
that it counts a step once; the kernels' launch counts count the rerun,
which is how the card shows it ran.

and the two switches of the training plane:

* ``gradsync`` — the reference's gradient-reduction mode: ``gspmd``
  (the framework reduces; on one device, no reduction), ``spindle``
  (fused buckets, one reduction per bucket), ``spindle_per_tensor`` (one
  per tensor) or ``spindle_compressed`` (fused buckets with the int8
  all-gather leg, through the ``quantize`` / ``dequantize`` sites);
* ``dp_workers`` — the data-parallel workers W, the counterpart of the
  size of the reference mesh's data axis.  The port folds them onto one
  card as a leading tensor dimension
  (:mod:`repro_torch.train.steps`); with W = 1 there is nothing to
  reduce, as on the reference's single device.

and the reference's mesh, as ranks (:mod:`repro_torch.core.ranks`):

* ``mesh`` — a :class:`~repro_torch.core.ranks.RankMesh`, one process a
  rank, each holding its own tensors: the train step reduces over the
  ``dp_axes`` (``("data",)``, or several such as ``("pod", "data")``)
  by collectives, and an MoE layer splits its experts over ``ep_axis``
  (``"model"``) when that axis has more than one rank
  (:meth:`Runtime.moe_ep_size`; a train step does so under ``gspmd``,
  :mod:`repro_torch.train.steps`).  The folded workers
  and the ranks are two ways to one result, chosen by the caller: a
  mesh of more than one rank with ``dp_workers`` > 1 is refused.  A
  mesh takes part in ``==`` and ``hash`` by identity, so runtimes on
  different groups never compare equal.

and the reference's sharding rules (:mod:`repro_torch.train.rules`):

* ``rules`` -- a logical-axis -> mesh-axis table, None by default.
  Without it every leaf is whole on every rank, as before the rules
  came.  With a preset on a mesh of more than one rank, a ``gspmd``
  train step, a prefill, a decode and the serving engine run on this
  rank's block of each parameter (``layers.spec_to_pspec``; the caller
  cuts them with ``layers.shard_params``): the heads, MLP columns and
  vocabulary rows split over ``"model"`` (``layers.TP_AXIS``, tensor
  parallelism) and the ``fsdp_embed`` dims over ``"data"`` (FSDP,
  gathered before use).  The table is kept as a sorted tuple of items,
  so a runtime still hashes and compares by value; :meth:`rules_`
  gives it back as a dict (the reference's ``DEFAULT_RULES`` without
  one).  Under ``seq_model``, ``megatron_seq`` and ``ssm_seq`` a call
  over a sequence that :func:`repro_torch.models.layers.seq_form`
  splits runs with each rank holding its rows of the stream: the entry
  points record that decision on the runtime they pass down
  (:meth:`Runtime.on_sequence`: the ``seq_split`` flag, and
  ``seq_rows`` for ``ssm_seq``'s form, where the row-wise mixers run on
  the rank's rows; both False by default), and every site reads it
  through :meth:`Runtime.seq_axis` and ``seq_rows``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import ops
from repro_torch.models import layers

if TYPE_CHECKING:
    from repro_torch.core.ranks import Axis, RankMesh

KERNEL_SITES = ("flash_decode", "rms_norm", "rms_norm_residual",
                "flash_attention", "ssd_scan", "quantize", "dequantize")
GRADSYNC_MODES = ("gspmd", "spindle", "spindle_per_tensor",
                  "spindle_compressed")
REMAT_POLICIES = ("none", "full", "dots")
# the dispatcher's matrix products (what ``torch.matmul``, ``einsum`` and
# ``F.linear`` lower to): the outputs ``remat="dots"`` keeps
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)

_recomputing = 0


def recomputing() -> bool:
    """Whether a checkpointed region is being rerun for the backward."""
    return _recomputing > 0


@contextlib.contextmanager
def _rerun(inner=None):
    global _recomputing
    with inner if inner is not None else contextlib.nullcontext():
        _recomputing += 1
        try:
            yield
        finally:
            _recomputing -= 1


def _full_contexts():
    return contextlib.nullcontext(), _rerun()


def _dots_contexts():
    forward, rerun = _ckpt.create_selective_checkpoint_contexts(
        list(DOT_OPS))
    return forward, _rerun(rerun)


@dataclasses.dataclass(frozen=True)
class Runtime:
    kernels: str = "kernels"          # kernels | plain
    gradsync: str = "gspmd"           # one of GRADSYNC_MODES
    dp_workers: int = 1               # data-parallel workers W
    remat: str = "none"               # one of REMAT_POLICIES
    mesh: Optional["RankMesh"] = None   # ranks (core/ranks.py), or None
    dp_axes: Tuple[str, ...] = ("data",)
    ep_axis: Optional[str] = "model"
    rules: Optional[Any] = None       # logical -> mesh axes, or None
    seq_split: bool = False           # set by on_sequence, see seq_axis
    seq_rows: bool = False            # set by on_sequence: ssm_seq's form

    def __post_init__(self):
        if self.rules is not None:
            object.__setattr__(self, "rules",
                               tuple(sorted(dict(self.rules).items())))
        if self.kernels not in ("kernels", "plain"):
            raise ValueError(f"kernels must be 'kernels' or 'plain', got "
                             f"{self.kernels!r}")
        if self.gradsync not in GRADSYNC_MODES:
            raise ValueError(f"gradsync must be one of {GRADSYNC_MODES}, "
                             f"got {self.gradsync!r}")
        if not isinstance(self.dp_workers, int) or self.dp_workers < 1:
            raise ValueError(f"dp_workers must be a positive int, got "
                             f"{self.dp_workers!r}")
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{self.remat!r}")
        if self.dp_workers > 1 and self.ranks > 1:
            raise ValueError(
                f"dp_workers={self.dp_workers} folds the workers onto one "
                f"device and the mesh {self.mesh.shape} runs them as ranks: "
                "pick one")

    @property
    def ranks(self) -> int:
        """The ranks of the mesh, 1 without one."""
        return 1 if self.mesh is None else self.mesh.world_size

    @property
    def spmd(self) -> bool:
        """Whether a train step reduces over workers (the reference's
        ``Runtime.spmd``: a mesh of more than one device): W > 1 folded
        workers, or a mesh of more than one rank."""
        return self.dp_workers > 1 or self.ranks > 1

    def rules_(self) -> Dict[str, Any]:
        """The rules as a dict: the runtime's, else the reference's
        default table (``layers.DEFAULT_RULES``)."""
        if self.rules is None:
            return dict(layers.DEFAULT_RULES)
        return dict(self.rules)

    def tp_axis(self) -> Optional["Axis"]:
        """The mesh's ``layers.TP_AXIS`` when the rules may split a leaf
        there (rules given, an axis of more than one rank), else None."""
        if self.rules is None or self.ranks <= 1 or \
                self.mesh.size(layers.TP_AXIS) <= 1:
            return None
        return self.mesh.axis(layers.TP_AXIS)

    def on_sequence(self, s: int, cfg=None) -> "Runtime":
        """This runtime for a call over a sequence of ``s`` positions of
        ``cfg``'s model: ``seq_split`` set where ``layers.seq_form``
        splits it, and ``seq_rows`` where it does so in ``ssm_seq``'s
        form (the row-wise mixers on the rank's rows), both cleared
        elsewhere (the one place that decides)."""
        form = layers.seq_form(self, s, cfg)
        split, rows = form is not None, form == "rows"
        if (split, rows) == (self.seq_split, self.seq_rows):
            return self
        return dataclasses.replace(self, seq_split=split, seq_rows=rows)

    def seq_axis(self) -> Optional["Axis"]:
        """The axis this call's sequence is split over (each rank holding
        its rows of the stream between the mixers): the mesh's
        ``layers.TP_AXIS`` when :meth:`on_sequence` set ``seq_split``,
        else None."""
        return self.tp_axis() if self.seq_split else None

    def moe_ep_size(self) -> int:
        """The ranks an MoE layer splits its experts over: the size of
        the mesh's ``ep_axis``, 1 off a mesh of more than one rank or
        without that axis (the reference's ``moe_ep_size``)."""
        if self.ranks <= 1 or self.ep_axis is None:
            return 1
        return self.mesh.size(self.ep_axis)

    def op(self, name: str):
        """The callable for one kernel site (see :data:`KERNEL_SITES`)."""
        if name not in KERNEL_SITES:
            raise KeyError(f"no kernel site {name!r}; have {KERNEL_SITES}")
        if self.kernels == "plain":
            return ops.PLAIN[name]
        return getattr(ops, name)

    def checkpoint(self, fn):
        """``fn`` under the remat policy: ``fn`` itself for ``none`` or
        with grad mode off (prefill, decode, serving and the captured
        programs are untouched), else ``fn`` wrapped by
        ``torch.utils.checkpoint`` (non-reentrant; the forward draws no
        random numbers, so no RNG state is kept).  ``fn`` must not modify
        its inputs in place: the rerun would read the modified values."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=(_dots_contexts if self.remat == "dots"
                        else _full_contexts))


CPU_RUNTIME = Runtime()
