"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Spins up the continuous-batching engine on a reduced config, feeds it a
synthetic request stream, and reports throughput/latency — the port of
``repro.launch.serve``, with its flags and its two printed lines.  It
runs on the GPU (and raises without one); :func:`serve` is the same run
for a caller that names the device (``device="cpu"``), the parameters
or the kernel sites' runtime.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import registry
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

MAX_LEN = 128


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, *, params=None,
          device: DeviceLike = None, rt: Runtime = Runtime()
          ) -> List[Request]:
    """Serve ``args.requests`` synthetic requests on ``args.arch``'s
    reduced config and print the reference's two lines; returns the
    drained requests.  ``params`` (a tree for the reduced config on
    ``device``) replaces the random weights from ``args.seed``."""
    dev = resolve_device(device)
    cfg = registry.get(args.arch).cfg.reduced()
    if params is None:
        params = registry.Arch(cfg).init_params(args.seed, dev)
    engine = ServeEngine(args.arch, params, cfg,
                         EngineConfig(max_batch=args.max_batch,
                                      max_len=MAX_LEN), rt, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    done = engine.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.tokens_out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {engine.decode_steps} decode steps, "
          f"{engine.rounds} rounds)")
    lat = [r.finished_at - r.submitted_at for r in done]
    print(f"latency mean {np.mean(lat)*1e3:.0f}ms p99 "
          f"{np.percentile(lat, 99)*1e3:.0f}ms")
    return done


def main(argv: Optional[List[str]] = None):
    serve(parse_args(argv))


if __name__ == "__main__":
    main()
