"""Driver ``serve_fused``: replicated serving over the multicast as the
fused program, ``ReplicatedEngine.run(fused=True)``.

A call is one offline batch: every replica's requests are submitted,
then one fused run serves them all.  Every call holds the same lengths,
so the program captured in set-up serves every call of the window.
Once the window has closed, a sample of the finished requests, drawn
from the seed with the longest among them, goes to the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference import qwen3
from yardstick import flops
from yardstick import traffic as gen
from yardstick import weights


class ServeFused:
    def __init__(self, config: Dict, traffic: Dict, ctx):
        import torch

        from repro_torch import api
        from repro_torch.core import graphloop

        self.config, self.traffic, self.ctx = config, traffic, ctx
        self.cfg = weights.model_config(config)
        self.params = weights.dense_decoder(config, ctx.seed, ctx.device)
        ecfg = api.EngineConfig(max_batch=traffic["slots"],
                                max_len=traffic["max_len"])
        self.engines = [api.ServeEngine(config["port_arch"], self.params,
                                        self.cfg, ecfg, device=ctx.device)
                        for _ in range(traffic["replicas"])]
        self.rep = api.ReplicatedEngine(
            self.engines,
            subscribers_per_replica=traffic["subscribers_per_replica"],
            window=traffic["window"], device=ctx.device)
        self._request = api.Request
        self._stats = graphloop.STATS
        self._torch = torch
        self._calls = 0
        self._zero()
        self.served: List = []
        self.call()                     # builds, captures, serves
        ctx.log("serve capture: " + ", ".join(
            f"{k} {v}" for k, v in self._program_stats().items()))
        self.call()                     # warm
        self._zero()
        self.served.clear()
        self._captures = self._stats["captures"]

    def _zero(self):
        self._totals = {"attempted": 0, "failed": 0, "tokens": 0,
                        "rounds": 0, "steps": 0, "flops": 0.0,
                        "decode_bytes": 0.0, "decode_flops": 0.0}

    def _program_stats(self) -> Dict:
        progs = list(self.rep._fused_programs.values())
        return {"graph_nodes": sum(p.nodes for p in progs),
                "capture_s": sum(p.capture_s for p in progs),
                "pool_bytes": sum(p.pool_bytes for p in progs)}

    def call(self) -> None:
        batch = gen.serve_batch(self.traffic, self.ctx.seed, self._calls,
                                self.cfg.vocab_size)
        self.rep.reset()
        rid = 0
        for g, reqs in enumerate(batch):
            for prompt, out in reqs:
                self.rep.submit(g, self._request(rid=rid, prompt=prompt,
                                                 max_new_tokens=out))
                rid += 1
        report = self.rep.run(fused=True)
        if self.ctx.device == "cuda":
            self._torch.cuda.synchronize()
        serve = report.extras["serve"]
        done = {r.rid: r.tokens_out for eng in self.engines
                for r in eng.completed}
        t = self._totals
        rid = 0
        for reqs in batch:
            for prompt, out in reqs:
                got = done.get(rid, [])
                t["attempted"] += 1
                t["failed"] += int(len(got) != out)
                self.served.append((prompt, np.asarray(got, np.int64)))
                t["flops"] += flops.decoder_tokens(self.config, len(prompt),
                                                   out)
                b, f = flops.flash_decode(self.config, len(prompt), out)
                t["decode_bytes"] += b
                t["decode_flops"] += f
                rid += 1
        t["tokens"] += serve["tokens"]
        t["rounds"] += serve.get("fused_rounds", serve["engine_rounds"])
        t["steps"] += serve["decode_steps"]
        t["fused"] = serve["fused"]
        self._calls += 1

    def counters(self) -> Dict:
        out = dict(self._totals)
        out["captures"] = self._stats["captures"] - self._captures
        return out

    def release(self) -> None:
        self.rep = None
        self.engines = None
        if self.ctx.device == "cuda":
            self._torch.cuda.empty_cache()

    def sample(self) -> List:
        """The requests the reference reads: the longest served, then
        others drawn from the seed, up to ``check_tokens`` tokens."""
        order = gen.rng(self.ctx.seed, 2 ** 31).permutation(
            len(self.served))
        longest = max(range(len(self.served)),
                      key=lambda i: self.served[i][1].size)
        picked, tokens = [], 0
        for i in [longest, *order]:
            if i in picked or tokens >= self.traffic["check_tokens"]:
                continue
            picked.append(i)
            tokens += self.served[i][1].size
        return [self.served[i] for i in picked]

    def gaps(self, quant=None) -> float:
        """The widest gap over the sample (the control's with
        ``quant``)."""
        torch = self._torch
        widest = 0.0
        with torch.no_grad():
            for prompt, got in self.sample():
                if got.size == 0:
                    return float("inf")
                dev = self.params["embed"].device
                g = qwen3.served_gaps(
                    self.params, self.config,
                    torch.as_tensor(prompt, device=dev),
                    torch.as_tensor(got, device=dev), quant)
                widest = max(widest, float(g.max()))
        return widest

    def checks(self) -> List:
        """The widest gap by which a served token's logit lies below the
        reference's best at its position, requests served short, and
        programs captured inside the window."""
        short = sum(1 for p, g in self.served if g.size == 0)
        return [("logit_gap", self.gaps(), self.traffic["gap_limit"]),
                ("requests_short", self._totals["failed"] + short, 0),
                ("window_captures", self.counters()["captures"], 0),
                ("fell_back", int(not self._totals.get("fused", False)),
                 0)]


def setup(config, traffic, ctx) -> ServeFused:
    return ServeFused(config, traffic, ctx)


def control_readings(config, traffic, ctx, seeds) -> List[Dict]:
    """Per seed, one call at the cell's size: the program's widest gap
    and the control's (the reference in float8) over the same sample.
    One capture serves every seed: each seed's weights are written into
    the same tensors."""
    import torch

    runner = ServeFused(config, traffic, ctx)
    out = []
    for seed in seeds:
        fresh = weights.dense_decoder(config, seed, ctx.device)
        for dst, src in zip(_leaves(runner.params), _leaves(fresh)):
            dst.copy_(src)
        del fresh
        runner.ctx.seed = seed
        runner._calls = 0
        runner.served.clear()
        runner.call()
        out.append({"seed": seed, "logit_gap": runner.gaps(),
                    "control_fp8": runner.gaps("fp8")})
        torch.cuda.empty_cache() if ctx.device == "cuda" else None
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree
