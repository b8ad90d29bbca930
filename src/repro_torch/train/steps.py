"""Step builders: the serving steps of an architecture.

:func:`make_serve_step` is the reference's
(``repro.train.steps.make_serve_step``): ``"prefill"`` runs the
architecture's prefill, or — for the recurrent families, whose prefill is
their chunked full forward — the loss forward over the same tokens;
``"decode"`` runs one decode step.  Training steps come with the training
plane.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.kernels.flash_attention import TRAINING_ITEM
from repro_torch.models.registry import Arch
from repro_torch.models.runtime import Runtime


def make_train_step(arch: Arch, rt: Runtime, *args, **kwargs) -> Callable:
    raise NotImplementedError(
        f"{arch.cfg.name}: training steps are not ported yet; they come "
        f"with {TRAINING_ITEM}")


def make_serve_step(arch: Arch, rt: Runtime, kind: str) -> Callable:
    """``"prefill"`` -> ``step(params, batch)``; ``"decode"`` ->
    ``step(params, cache, batch, position)``."""
    cfg = arch.cfg
    if kind == "prefill":
        fn = arch.prefill_fn()
        if fn is not None:
            return lambda params, batch: fn(params, batch, rt)
        # recurrent families: prefill == the chunked full forward; run the
        # loss forward (the same compute) over the batch
        loss_fn = arch.loss_fn()
        return lambda params, batch: loss_fn(params, cfg, batch, rt)
    if kind == "decode":
        decode = arch.decode_fn()

        def serve_step(params, cache, batch, position):
            return decode(params, cfg, cache, batch["tokens"], position, rt)

        return serve_step
    raise KeyError(kind)
