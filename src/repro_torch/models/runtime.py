"""Runtime context: which implementation the kernel sites use, and how a
train step reduces its gradients.

The reference threads a ``Runtime`` (mesh, sharding rules, ``attn_impl``,
``gradsync``) through every forward function and train step.  One device
serves here, so what is left is the switch between the hand-written
kernels and their plain versions:

* ``kernels="kernels"`` (the default) calls the wrappers of
  :mod:`repro_torch.kernels.ops`: on CUDA tensors they launch the Hopper
  kernels (or raise), on CPU tensors they run the plain versions;
* ``kernels="plain"`` calls the plain versions on any device — the
  comparison runs of ``chip_smoke.py`` ask for it explicitly.

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
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops

KERNEL_SITES = ("flash_decode", "rms_norm", "rms_norm_residual",
                "flash_attention", "ssd_scan", "quantize", "dequantize")
GRADSYNC_MODES = ("gspmd", "spindle", "spindle_per_tensor",
                  "spindle_compressed")


@dataclasses.dataclass(frozen=True)
class Runtime:
    kernels: str = "kernels"          # kernels | plain
    gradsync: str = "gspmd"           # one of GRADSYNC_MODES
    dp_workers: int = 1               # data-parallel workers W

    def __post_init__(self):
        if self.kernels not in ("kernels", "plain"):
            raise ValueError(f"kernels must be 'kernels' or 'plain', got "
                             f"{self.kernels!r}")
        if self.gradsync not in GRADSYNC_MODES:
            raise ValueError(f"gradsync must be one of {GRADSYNC_MODES}, "
                             f"got {self.gradsync!r}")
        if not isinstance(self.dp_workers, int) or self.dp_workers < 1:
            raise ValueError(f"dp_workers must be a positive int, got "
                             f"{self.dp_workers!r}")

    @property
    def spmd(self) -> bool:
        """Whether a train step reduces over workers (the reference's
        ``Runtime.spmd``: a mesh of more than one device)."""
        return self.dp_workers > 1

    def op(self, name: str):
        """The callable for one kernel site (see :data:`KERNEL_SITES`)."""
        if name not in KERNEL_SITES:
            raise KeyError(f"no kernel site {name!r}; have {KERNEL_SITES}")
        if self.kernels == "plain":
            return ops.PLAIN[name]
        return getattr(ops, name)


CPU_RUNTIME = Runtime()
