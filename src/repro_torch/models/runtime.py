"""Runtime context: which implementation the models' kernel sites use.

The reference threads a ``Runtime`` (mesh, sharding rules, ``attn_impl``)
through every forward function.  One device serves here, so what is left
is the switch between the hand-written kernels and their plain versions:

* ``kernels="kernels"`` (the default) calls the wrappers of
  :mod:`repro_torch.kernels.ops`: on CUDA tensors they launch the Hopper
  kernels (or raise), on CPU tensors they run the plain versions;
* ``kernels="plain"`` calls the plain versions on any device — the
  comparison runs of ``chip_smoke.py`` ask for it explicitly.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops

KERNEL_SITES = ("flash_decode", "rms_norm", "rms_norm_residual",
                "flash_attention", "ssd_scan")


@dataclasses.dataclass(frozen=True)
class Runtime:
    kernels: str = "kernels"          # kernels | plain

    def __post_init__(self):
        if self.kernels not in ("kernels", "plain"):
            raise ValueError(f"kernels must be 'kernels' or 'plain', got "
                             f"{self.kernels!r}")

    def op(self, name: str):
        """The callable for one kernel site (see :data:`KERNEL_SITES`)."""
        if name not in KERNEL_SITES:
            raise KeyError(f"no kernel site {name!r}; have {KERNEL_SITES}")
        if self.kernels == "plain":
            return ops.PLAIN[name]
        return getattr(ops, name)


CPU_RUNTIME = Runtime()
