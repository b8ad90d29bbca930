"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``.

The port of ``repro.launch.train``, with its flags.  It trains the full
config on the GPU (and raises without one) unless ``--reduced`` asks
for the same family at smoke scale; the Trainer prints a line a logged
step.  :func:`train` is the same run for a caller that names the device
(``device="cpu"``).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

from repro_torch import DeviceLike
from repro_torch.models import registry
from repro_torch.models.runtime import Runtime
from repro_torch.train.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(steps=args.steps, seq_len=args.seq_len,
                       global_batch=args.global_batch,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every,
                       log_every=args.log_every, seed=args.seed)


def train(args: argparse.Namespace, *, device: DeviceLike = None,
          on_step: Optional[Callable[[int, Dict], None]] = None
          ) -> Trainer:
    """Build the Trainer ``args`` describe on ``device``, run it
    (``on_step`` as :meth:`Trainer.run` takes it), and return it
    (``trainer.history`` holds the logged steps)."""
    arch = registry.get(args.arch)
    cfg = arch.cfg.reduced() if args.reduced else arch.cfg
    trainer = Trainer(args.arch, cfg, train_config(args), Runtime(),
                      device=device)
    trainer.run(on_step=on_step)
    return trainer


def main(argv: Optional[List[str]] = None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
