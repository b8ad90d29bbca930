"""Driver ``train``: the port's training step, ``make_train_step`` (the
step a ``Trainer`` runs), with the parameters and the AdamW state
updated in place.

Set-up makes the weights from the seed, builds the step and drives it
through its first steps on the window's own feed; those steps are what
the reference follows: each step's loss, the first gradient as the
optimizer took it (read from its first moment after one step) and each
leaf's change after the last of them.  A call is one more step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from reference import train as ref_train
from yardstick import flops
from yardstick import traffic as gen
from yardstick import weights


class Train:
    def __init__(self, config: Dict, traffic: Dict, ctx):
        import torch

        from repro_torch import api
        from repro_torch.optim import adamw

        self.config, self.traffic, self.ctx = config, traffic, ctx
        self._torch = torch
        cfg = weights.model_config(config)
        self.vocab = cfg.vocab_size
        o = traffic["opt"]
        self.opt = api.OptConfig(
            peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
            decay_steps=o["decay_steps"], min_lr_frac=o["min_lr_frac"],
            b1=o["b1"], b2=o["b2"], eps=o["eps"],
            weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
        rt = api.Runtime(gradsync=traffic["gradsync"],
                         remat=traffic["remat"])
        self.step_fn = api.make_train_step(
            api.Arch(cfg), rt, self.opt,
            param_dtype=weights.dtype_of(config), donate=True)
        self.params = weights.dense_decoder(config, ctx.seed, ctx.device)
        self.state = adamw.init(self.params)
        self.step = 0
        self.losses: List[float] = []
        self._zero()
        self.first_grad = None
        for _ in range(traffic["checked_steps"]):
            self.call()
            if self.first_grad is None:
                self.first_grad = {
                    n: float(m.norm()) / (1 - self.opt.b1)
                    for n, m in ref_train.paths(self.state["m"])}
        self.checked_loss = list(self.losses)
        self.change = self._change()
        self.call()                     # warm: a step past the checked
        self._zero()

    def _zero(self):
        self._totals = {"attempted": 0, "failed": 0, "tokens": 0,
                        "flops": 0.0}

    def _change(self) -> Dict[str, float]:
        start = weights.dense_decoder(self.config, self.ctx.seed,
                                      self.ctx.device)
        out = {n: float((m - s.float()).norm()) for (n, m), (_, s) in zip(
            ref_train.paths(self.state["master"]), ref_train.paths(start))}
        del start
        return out

    def batch(self, step: int):
        return self._torch.as_tensor(
            gen.train_tokens(self.traffic, self.ctx.seed, step, self.vocab),
            device=self.ctx.device)

    def call(self) -> None:
        tokens = self.batch(self.step)
        self.params, self.state, metrics = self.step_fn(
            self.params, self.state, {"tokens": tokens})
        loss = float(metrics["loss"])
        self.losses.append(loss)
        t = self._totals
        t["attempted"] += 1
        t["failed"] += int(not math.isfinite(loss))
        b, s = tokens.shape
        t["tokens"] += b * s
        t["flops"] += flops.train_step(self.config, b, s)
        self.step += 1

    def counters(self) -> Dict:
        return dict(self._totals)

    def release(self) -> None:
        self.params = self.state = self.step_fn = None
        if self.ctx.device == "cuda":
            self._torch.cuda.empty_cache()

    def reference(self, quant=None) -> Dict:
        params0 = weights.dense_decoder(self.config, self.ctx.seed,
                                        self.ctx.device)
        batches = [self.batch(k)
                   for k in range(self.traffic["checked_steps"])]
        return ref_train.run(params0, self.config, self.traffic["opt"],
                             batches, quant)

    def readings(self, ref: Dict) -> Dict[str, float]:
        """The three compared numbers against ``ref``: the largest
        relative loss gap over the checked steps, and by the worst leaf
        the gap of the first gradient's norm and of the change's norm,
        each over the larger of the leaf's reference norm and the median
        leaf's.  Leaves whose reference gradient is under a thousandth of
        the median leaf's are left out of the change."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(self.checked_loss,
                                                       ref["loss"]))
        g_med = float(np.median(list(ref["grad"].values())))
        c_med = float(np.median(list(ref["change"].values())))
        grad = max(abs(self.first_grad[n] - r) / max(r, g_med)
                   for n, r in ref["grad"].items())
        change = max(abs(self.change[n] - r) / max(r, c_med)
                     for n, r in ref["change"].items()
                     if ref["grad"][n] >= 1e-3 * g_med)
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}

    def checks(self) -> List:
        got = self.readings(self.reference())
        lim = self.traffic["limits"]
        return [(k, v, lim[k]) for k, v in got.items()] + [
            ("failed_steps", self._totals["failed"], 0)]


def setup(config, traffic, ctx) -> Train:
    return Train(config, traffic, ctx)


def control_readings(config, traffic, ctx, seeds) -> List[Dict]:
    """Per seed, the program's three readings and the control's (the
    reference with float8 products put in the program's place: its
    readings against the float32 reference)."""
    out = []
    for seed in seeds:
        ctx.seed = seed
        runner = Train(config, traffic, ctx)
        runner.release()
        ref = runner.reference()
        row = {"seed": seed, "program": runner.readings(ref)}
        low = runner.reference("fp8")
        runner.checked_loss = low["loss"]
        runner.first_grad = low["grad"]
        runner.change = low["change"]
        row["control_fp8"] = runner.readings(ref)
        out.append(row)
    return out


def fault_readings(config, traffic, ctx, seeds) -> List[Dict]:
    """Per seed, the readings of the program with half of each batch
    left out (the mean taken over the rest) against the whole batch's
    reference; a state left unchanged reads 1 on the change and needs
    no run."""
    full = Train.batch
    out = []
    for seed in seeds:
        ctx.seed = seed
        Train.batch = lambda self, step: full(self, step)[:1]
        try:
            runner = Train(config, traffic, ctx)
        finally:
            Train.batch = full
        runner.release()
        out.append({"seed": seed, "half_batch": runner.readings(
            runner.reference())})
    return out
