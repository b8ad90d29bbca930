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

With ``rt.mesh`` every rank runs its own ``Trainer``: rank ``r`` of the
data axes' ``n`` (their product, ``steps.batch_axis``) loads rows ``[r
B/n, (r + 1) B/n)`` of each global batch (``pipeline.ShardedLoader(
rank=r, n_ranks=n)``, the folded path's worker ``r``), on the mesh's
device unless ``device`` says otherwise.  Where the train step splits
the MoE's experts over ``rt.ep_axis`` (``steps.splits_experts``) a rank
holds its experts' rows of the parameters and of their AdamW state
(``moe.shard_experts`` by its index on that axis) and everything else
whole.  The mesh's rank 0 alone writes checkpoints, always the whole
tree in the reference's layout (the expert leaves gathered over the
expert axis first); every rank waits for the write and every rank
restores, cutting its experts again, so ``history`` and the
``SyncState`` watermarks are the same on every rank.  Where ``rt.rules``
lay out the parameters (``steps.splits_layout``) a rank holds its
blocks of every leaf and of its AdamW state (``layers.shard_params``),
cut from the unsplit initialisation, gathered whole
(``layers.gather_params``) for a checkpoint and cut again on a restore,
the same way.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core.gradsync import SyncState
from repro_torch.data import pipeline
from repro_torch.models import layers, moe, registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import checkpoint
from repro_torch.train.steps import (batch_axis, make_train_step,
                                     splits_experts, splits_layout)

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
        if device is None and rt.mesh is not None:
            device = rt.mesh.device
        self.device = resolve_device(device)
        self.data_cfg = pipeline.DataConfig(
            seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            n_patterns=tcfg.data_patterns)
        rank, n_ranks = 0, 1
        axis = None if rt.mesh is None else batch_axis(self.arch, rt)
        if axis is not None:
            rank, n_ranks = axis.index, axis.size
        # the expert axis when this rank holds its experts' part
        self.experts = rt.mesh.axis(rt.ep_axis) \
            if splits_experts(self.arch, rt) else None
        # the rules' layout, (specs, rules, mesh), when this rank holds
        # its blocks of the parameters
        self.layout = (self.arch.param_specs(), rt.rules_(), rt.mesh) \
            if splits_layout(self.arch, rt) else None
        self.loader = pipeline.ShardedLoader(self.data_cfg, rank=rank,
                                             n_ranks=n_ranks)
        # the one process that writes checkpoints and prints the log
        self.writer = rt.mesh is None or rt.mesh.rank == 0
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
        params = self._own(params)
        return params, adamw.init(params)

    def _own(self, tree):
        """This rank's part of a whole tree: its blocks under the rules'
        layout, its experts' rows where the experts are split, else the
        tree itself."""
        if self.layout is not None:
            return layers.shard_params(tree, *self.layout)
        if self.experts is None:
            return tree
        return moe.shard_experts(tree, self.experts.index,
                                 self.experts.size)

    def _whole(self, tree):
        """The whole tree from every rank's part (every rank calls it)."""
        if self.layout is not None:
            return layers.gather_params(tree, *self.layout)
        if self.experts is not None:
            return moe.gather_experts(tree, self.experts)
        return tree

    def maybe_restore(self, params, opt_state):
        """The latest checkpoint's step and state, or ``(0, params,
        opt_state)`` without one.  A checkpoint holds the state after an
        update, which casts every parameter to ``param_dtype`` (a float32
        spec such as the MoE router included), so the parameters come
        back in ``param_dtype`` whatever ``params``' dtypes: a resumed
        run then takes the same steps as an unbroken one, bit for bit.
        (The reference restores into ``params``' dtypes: a float32
        router it resumes in float32.)"""
        d = self.tcfg.checkpoint_dir
        if not d or checkpoint.latest_step(d) is None:
            return 0, params, opt_state
        like = {"params": params, "opt": opt_state}
        if self.layout is not None:
            like = layers.whole_like(like, *self.layout)
        elif self.experts is not None:
            like = moe.whole_like(like, self.experts.size)
        step, tree, _extra = checkpoint.restore(d, like)
        tree = self._own(tree)
        self.sync = SyncState(delivered_step=step, sent_step=step)
        restored = tree_util.map(lambda t: t.to(self.tcfg.param_dtype),
                                 tree["params"])
        return step, restored, tree["opt"]

    # -- the loop --------------------------------------------------------------

    def _batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch on the trainer's device: the token
        stream, and for the encdec and vlm families the reference's stub
        frontends over it (``src/repro/train/trainer.py``): the encdec
        takes ``frames = one_hot(tokens[:, :S/2] % d_model)`` and the
        targets ``tokens[:, S/2:]``, the vlm ``patches =
        one_hot(tokens[:, :n_patches] % vision_dim)`` and the text
        ``tokens[:, n_patches:]``.  The one-hot inputs are in the
        weights' dtype (``param_dtype``), where the reference's are
        bfloat16 (the same values)."""
        raw = self.loader.batch(step)
        toks = torch.from_numpy(raw["tokens"]).to(self.device)
        if self.cfg.family == "encdec":
            half = toks.shape[1] // 2
            return {"frames": self._one_hot(toks[:, :half],
                                            self.cfg.d_model),
                    "tokens": toks[:, half:]}
        if self.cfg.family == "vlm":
            n_p = self.cfg.vlm.n_patches
            return {"patches": self._one_hot(toks[:, :n_p],
                                             self.cfg.vlm.vision_dim),
                    "tokens": toks[:, n_p:]}
        return {"tokens": toks}

    def _one_hot(self, tokens: torch.Tensor, width: int) -> torch.Tensor:
        return torch.nn.functional.one_hot(
            (tokens % width).long(), width).to(self.tcfg.param_dtype)

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
                if self.writer:
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
        tree = self._whole({"params": params, "opt": opt_state})
        if self.writer:
            checkpoint.save(self.tcfg.checkpoint_dir, step, tree,
                            extra={"arch": self.cfg.name})
            checkpoint.prune(self.tcfg.checkpoint_dir,
                             self.tcfg.keep_checkpoints)
        if self.rt.mesh is not None:
            dist.barrier()            # the checkpoint is on disk for all
        self.sync = self.sync.deliver(step)
