"""The training loop: checkpoint and restart, the Spindle gradient
reduction, AdamW — the port of ``repro.train.trainer``.

``Trainer(arch_name, cfg, tcfg, rt, device)`` builds the train step of
:func:`repro_torch.train.steps.make_train_step` for ``cfg`` with the
``Runtime`` ``rt`` (``rt.gradsync`` and ``rt.dp_workers`` pick the
reduction; the data-parallel workers are folded onto the one device),
feeds it the deterministic token stream of
:mod:`repro_torch.data.pipeline`, and publishes checkpoints with
:mod:`repro_torch.train.checkpoint`, advancing the ``SyncState``
watermarks as the reference does.  The step updates the parameters and
the optimizer state in place (the reference donates them to its jitted
step).  Elastic view changes run in
:class:`repro_torch.train.elastic.ElasticRuntime`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.gradsync import SyncState
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.steps import make_train_step

PyTree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    data_patterns: int = 512     # synthetic-stream difficulty
    opt: adamw.OptConfig = dataclasses.field(default_factory=adamw.OptConfig)
    # the dtype of the parameters and of every update's cast (the
    # reference's fixed ``adamw.update`` default, bfloat16)
    param_dtype: torch.dtype = torch.bfloat16


class Trainer:
    def __init__(self, arch_name: str, cfg: ModelConfig, tcfg: TrainConfig,
                 rt: Runtime = Runtime(), device: DeviceLike = None):
        registry.get(arch_name)          # the name must be registered
        self.arch = registry.Arch(cfg)
        self.cfg = cfg
        self.tcfg = tcfg
        self.rt = rt
        self.device = resolve_device(device)
        self.data_cfg = pipeline.DataConfig(
            seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            n_patterns=tcfg.data_patterns)
        self.loader = pipeline.ShardedLoader(self.data_cfg, rank=0,
                                             n_ranks=1)
        self.sync = SyncState()
        self.history: List[Dict[str, float]] = []
        self._step = make_train_step(self.arch, rt, tcfg.opt,
                                     param_dtype=tcfg.param_dtype,
                                     donate=True)

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None):
        """Random parameters from ``seed`` (the config's by default) in
        ``param_dtype`` on the trainer's device, and their AdamW state."""
        seed = self.tcfg.seed if seed is None else seed
        params = self.arch.init_params(seed, self.device,
                                       self.tcfg.param_dtype)
        return params, adamw.init(params)

    def maybe_restore(self, params, opt_state):
        d = self.tcfg.checkpoint_dir
        if not d or checkpoint.latest_step(d) is None:
            return 0, params, opt_state
        step, tree, _extra = checkpoint.restore(
            d, {"params": params, "opt": opt_state})
        self.sync = SyncState(delivered_step=step, sent_step=step)
        return step, tree["params"], tree["opt"]

    # -- the loop --------------------------------------------------------------

    def _batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s token batch on the device (the dense and ssm
        families; a trainer of the hybrid family raises at construction,
        naming ROADMAP item 22, and of the moe, vlm and encdec families
        naming item 24)."""
        raw = self.loader.batch(step)
        return {"tokens": torch.from_numpy(raw["tokens"]).to(self.device)}

    def run(self, params=None, opt_state=None,
            on_step: Optional[Callable[[int, Dict], None]] = None):
        if params is None:
            params, opt_state = self.init_state()
        start, params, opt_state = self.maybe_restore(params, opt_state)
        t0 = time.time()
        for step in range(start, self.tcfg.steps):
            batch = self._batch_for(step)
            params, opt_state, metrics = self._step(params, opt_state,
                                                    batch)
            self.sync = self.sync.advance()
            if (step + 1) % self.tcfg.log_every == 0 or \
                    step == self.tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                print(f"step {step+1:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}",
                      flush=True)
            if self.tcfg.checkpoint_dir and \
                    (step + 1) % self.tcfg.checkpoint_every == 0:
                self._save(step + 1, params, opt_state)
            if on_step:
                on_step(step, metrics)
        if self.tcfg.checkpoint_dir:
            self._save(self.tcfg.steps, params, opt_state)
        return params, opt_state

    def _save(self, step: int, params, opt_state):
        checkpoint.save(self.tcfg.checkpoint_dir, step,
                        {"params": params, "opt": opt_state},
                        extra={"arch": self.cfg.name})
        self.sync = self.sync.deliver(step)
        checkpoint.prune(self.tcfg.checkpoint_dir,
                         self.tcfg.keep_checkpoints)
