"""Driver ``stream_fused``: the multicast as one continuous stream through
the load harness's fused round program, the device half of
``run_profile(group, profile, AdmitAll(), fused=True)``.

The stream is opened once in set-up and never restarted.  A call loads
the next ``rounds`` rounds of arrivals and runs them as the round program
captured in set-up: the admission and the stream round body on the
device, with no host read between rounds.  The host half of
``run_profile`` (its drain, its per-message FIFO replay and its report)
is not on the path: the delivered messages are read from the device's
per-round matrices instead.  Every round's matrices are kept for the
reference, which follows the whole stream from its first round once the
window has closed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference import smc
from yardstick import traffic as gen

TRACES = ("batch", "pub", "nulls", "release")


class StreamFused:
    def __init__(self, config: Dict, traffic: Dict, ctx):
        import torch

        from repro_torch import api
        from repro_torch.core import graphloop
        from repro_torch.load.admission import AdmitAll
        from repro_torch.load.harness import _LoadPrograms

        if traffic["admission"] != "all":
            raise ValueError("stream_fused drives AdmitAll only")
        self.config, self.traffic, self.ctx = config, traffic, ctx
        self._torch = torch
        flags = getattr(api.SpindleFlags, config["flags"])()
        group = api.Group(api.single_group(
            config["n_nodes"], config["n_senders"],
            msg_size=config["msg_size"], window=config["window"],
            n_messages=1, flags=flags), device=ctx.device)
        stream = group.stream(backend=config["backend"])
        g_n, s_max = stream.shape
        mask = np.zeros((g_n, s_max), bool)
        mask[0, :config["n_senders"]] = True
        policy = AdmitAll()
        self.progs = _LoadPrograms(stream, policy, traffic["rounds"], mask)
        self.progs.state["pol"].copy_(policy.device_init((g_n, s_max),
                                                         ctx.device))
        self._stats = graphloop.STATS
        self._calls = 0
        self._failed = 0
        self._ref = None
        self.rows: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("arrivals",) + TRACES}
        for _ in range(2):              # build, capture, then a warm call
            self.call()
        self._from = self._calls
        self._failed = 0
        self._captures = self._stats["captures"]

    def call(self) -> None:
        s = self.progs.state
        arr = gen.stream_arrivals(self.traffic, self.ctx.seed, self._calls,
                                  self.config["n_senders"])
        s["arr"].copy_(self._torch.as_tensor(arr[:, None, :],
                                             dtype=self._torch.int32))
        s["t"].zero_()
        s["running"].fill_(True)
        self.progs.profile.run()
        n, m = self.config["n_senders"], self.config["n_nodes"]
        self.rows["arrivals"].append(arr)
        for k in TRACES:
            lanes = m if k == "batch" else n
            self.rows[k].append(s["p_" + k][:, 0, :lanes].cpu().numpy()
                                .copy())
        self._failed += int(int(s["t"]) != self.traffic["rounds"])
        self._calls += 1

    def traces(self) -> Dict[str, np.ndarray]:
        """Every round streamed so far, set-up's included."""
        return {k: np.concatenate(v).astype(np.int64)
                for k, v in self.rows.items()}

    def counters(self) -> Dict:
        tr = self.traces()
        apps = smc.apps_everywhere(tr["batch"], tr["pub"], tr["nulls"])
        t = self.traffic["rounds"]
        return {"attempted": self._calls - self._from,
                "failed": self._failed,
                "rounds": (self._calls - self._from) * t,
                "delivered": int(apps[-1] - apps[self._from * t - 1]),
                "captures": self._stats["captures"] - self._captures}

    def release(self) -> None:
        self.progs = None

    def readings(self, got: Dict[str, np.ndarray] = None
                 ) -> Dict[str, int]:
        """Every round of the stream (or ``got``'s rounds in its place)
        against the reference fed the same arrivals: member-rounds whose
        delivered count differs (the delivery order and watermarks at
        every member), sender-rounds whose app or null publishes differ,
        and sender-rounds whose release differs from the arrivals
        (AdmitAll)."""
        tr = self.traces()
        if self._ref is None or len(self._ref[0]) != len(tr["arrivals"]):
            self._ref = smc.simulate(tr["arrivals"], self.config["n_nodes"],
                                     self.config["window"])
        tr.update(got or {})
        want, pub, nulls, _ = self._ref
        return {"delivery_mismatches": int(np.sum(tr["batch"] != want)),
                "publish_mismatches": int(np.sum(tr["pub"] != pub)
                                          + np.sum(tr["nulls"] != nulls)),
                "release_mismatches": int(np.sum(tr["release"]
                                                 != tr["arrivals"]))}

    def checks(self) -> List:
        got = self.readings()
        return [(k, v, 0) for k, v in got.items()] + [
            ("window_captures", self.counters()["captures"], 0),
            ("failed_calls", self._failed, 0)]


def setup(config, traffic, ctx) -> StreamFused:
    return StreamFused(config, traffic, ctx)


def control_readings(config, traffic, ctx, seeds) -> List[Dict]:
    """Per seed, ``ctx.seconds`` of calls at the cell's load: the
    program's readings, and the control's (the reference delivering
    without waiting for stability, put in the program's place) on the
    same arrivals."""
    import time

    out = []
    for seed in seeds:
        ctx.seed = seed
        runner = StreamFused(config, traffic, ctx)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            runner.call()
        runner.release()
        arrivals = runner.traces()["arrivals"]
        batch, pub, nulls, _ = smc.simulate(arrivals, config["n_nodes"],
                                            config["window"],
                                            stability=False)
        out.append({"seed": seed, "rounds": arrivals.shape[0],
                    "program": runner.readings(),
                    "control": runner.readings(
                        {"batch": batch, "pub": pub, "nulls": nulls})})
    return out
