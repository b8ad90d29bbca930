"""The open-loop load harness: run a profile against a target, get a
:class:`~repro_torch.load.metrics.LoadReport` (DESIGN.md Sec. 10).

Targets, in ascending stack depth:

* a bare :class:`~repro_torch.core.group.Group` / ``GroupStream`` — the
  protocol plane alone;
* a :class:`~repro_torch.core.dds.BoundDomain` — the same stream behind
  the topic-keyed DDS front (arrival lanes are topic publishers);
* a :class:`~repro_torch.serve.fanout.ReplicatedEngine` — the serve plane
  (arrivals become requests; latency is submit -> finish in engine
  rounds).

The stream path is the reference loop: per round, arrivals land in
per-lane FIFO queues; the admission policy releases/sheds against the
previous round's SMC backlog watermark; the released counts become the
round's ``step(ready)``; after the last stage the admission queue keeps
releasing (no new arrivals) until it empties, then the stream drains
(:meth:`finish`) and per-message latencies are reconstructed from the
round traces (:mod:`repro_torch.load.metrics`).  Everything is
deterministic given (profile, target, policy): ``graph`` and ``kernel``,
on the card and on the CPU, produce byte-identical reports.

``fused=True`` runs the same accounting off device round programs
(:class:`repro_torch.core.graphloop.RoundProgram`, one round captured as
a CUDA graph): the profile's rounds over the precomputed ``(T, G, S)``
arrival matrix, each the admission policy's
:meth:`~repro_torch.load.admission.AdmissionPolicy.device_admit` and the
stream round body, with no host read between rounds; then drain chunks
of 128 rounds with the host loop's ``idle < 64 and queue nonempty`` gate
evaluated on the device.  Per-message FIFO attribution is REPLAYED on
the host from the device's release/shed matrices (identical arithmetic,
so identical queues), and the rounds are absorbed into the stream
(:meth:`~repro_torch.core.group.GroupStream.absorb`) so
``finish``/``build_report`` post-process through the exact unfused
machinery.  The resulting :class:`LoadReport` is byte-identical to the
per-round loop's — fused runs mark themselves only in
``run_report.extras['load_fused']``.  Non-lowerable policies fall back
silently to the host loop.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dds as dds_mod
from repro_torch.core import group as group_mod
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.graphloop import RoundProgram
from repro_torch.load.admission import (AdmissionPolicy, AdmitAll,
                                        ServeAdmission)
from repro_torch.load.metrics import (LoadReport, StageStats, StageTally,
                                      build_report)
from repro_torch.load.profiles import Profile

I32 = torch.int32


def _resolve_stream(target, backend: str):
    if isinstance(target, group_mod.Group):
        return target.stream(backend=backend)
    if isinstance(target, group_mod.GroupStream):
        return target
    if isinstance(target, dds_mod.BoundDomain):
        return target.stream
    raise TypeError(
        f"cannot load-test {type(target).__name__}; pass a Group, "
        "GroupStream, BoundDomain, or ReplicatedEngine")


def run_profile(target, profile: Profile,
                admission: Optional[AdmissionPolicy] = None, *,
                backend: str = "kernel",
                settle_max: Optional[int] = None,
                max_new_tokens: int = 4,
                prompt_len: int = 2,
                fused: bool = False) -> LoadReport:
    """Drive ``target`` open-loop through ``profile`` and account the
    result.  ``admission`` defaults to :class:`AdmitAll` (the
    uncontrolled baseline) on stream targets and must be a
    :class:`ServeAdmission` (or None) on a ``ReplicatedEngine``.
    ``backend`` picks the stream substrate when ``target`` is a bare
    ``Group`` (on the Group's device); ``settle_max`` caps the
    post-profile drain (capped-off messages report as ``undelivered``).
    ``max_new_tokens`` / ``prompt_len`` shape the synthetic requests on
    the serve path.  ``fused=True`` runs the profile through the fused
    device programs (byte-identical report, see the module docstring);
    it falls back to the host loop when the policy cannot be lowered."""
    if hasattr(target, "engines") and hasattr(target, "submit"):
        return _run_serve_profile(target, profile, admission,
                                  settle_max=settle_max,
                                  max_new_tokens=max_new_tokens,
                                  prompt_len=prompt_len,
                                  fused=fused)
    stream = _resolve_stream(target, backend)
    if stream.rounds or stream.carry is not None:
        raise ValueError(
            "load profiles need a fresh stream: rounds already streamed "
            "or an epoch carry would misalign the FIFO latency "
            "accounting")
    policy = admission if admission is not None else AdmitAll()
    if isinstance(policy, ServeAdmission):
        raise TypeError("ServeAdmission lowers to the serve plane; "
                        "stream targets take an AdmissionPolicy")
    g_n, s_max = stream.shape
    mask = np.zeros((g_n, s_max), bool)
    for g, s_g in enumerate(stream.n_senders):
        mask[g, :s_g] = True
    windows = np.asarray(stream.windows, np.int64)
    stage_mats = profile.matrices((g_n, s_max), mask)
    if fused:
        report = _run_stream_profile_fused(stream, profile, policy,
                                           mask, stage_mats,
                                           settle_max)
        if report is not None:
            return report
    pending: List[List[collections.deque]] = [
        [collections.deque() for _ in range(s_max)] for _ in range(g_n)]
    rel_rounds: List[List[List[int]]] = [
        [[] for _ in range(s_max)] for _ in range(g_n)]
    rel_stages: List[List[List[int]]] = [
        [[] for _ in range(s_max)] for _ in range(g_n)]
    tallies: List[StageTally] = [
        StageTally(name=st.name, rounds=st.rounds, scale=st.scale)
        for st in profile.stages]
    view = None
    t_global = 0

    def admit_round(tally: StageTally):
        nonlocal view, t_global
        queued = np.array([[len(pending[g][s]) for s in range(s_max)]
                           for g in range(g_n)], np.int64)
        backlog = (np.where(mask, view.backlog, 0).astype(np.int64)
                   if view is not None
                   else np.zeros((g_n, s_max), np.int64))
        release, shed = policy.admit(t_global, queued, backlog, windows)
        release = np.minimum(np.maximum(release, 0), queued)
        shed = np.minimum(np.maximum(shed, 0), queued - release)
        # released/shed counts go to the message's ARRIVAL stage, same
        # attribution as the delivered/latency stats built from traces
        for g, s in zip(*np.nonzero(release)):
            for _ in range(int(release[g, s])):
                a_rnd, a_stage = pending[g][s].popleft()
                rel_rounds[g][s].append(a_rnd)
                rel_stages[g][s].append(a_stage)
                tallies[a_stage].released += 1
        for g, s in zip(*np.nonzero(shed)):
            for _ in range(int(shed[g, s])):
                _, a_stage = pending[g][s].pop()  # tail drop: newest
                tallies[a_stage].shed += 1
        view = stream.step(release.astype(np.int32))
        depth = int(queued.sum() - release.sum() - shed.sum())
        tally.max_queue_depth = max(tally.max_queue_depth, depth)
        bl = int(np.where(mask, view.backlog, 0).sum())
        tally.max_stream_backlog = max(tally.max_stream_backlog, bl)
        t_global += 1
        return int(release.sum() + shed.sum())

    for si, (stage, mat) in enumerate(zip(profile.stages, stage_mats)):
        tally = tallies[si]
        for t in range(stage.rounds):
            arr = mat[t]
            tally.offered += int(arr.sum())
            for g, s in zip(*np.nonzero(arr)):
                pending[g][s].extend([(t_global, si)] * int(arr[g, s]))
            admit_round(tally)
        tally.end_queue_depth = int(
            sum(len(q) for row in pending for q in row))
    # drain the admission queue: arrivals stopped, but admitted-but-queued
    # work keeps releasing under the same policy until the lanes empty (or
    # the policy stalls for 64 straight rounds — leftovers then report as
    # end_queue_depth).  Without this, overload goodput misreports the
    # plateau as collapse purely from stranded-queue accounting.
    idle = 0
    while (idle < 64
           and any(q for row in pending for q in row)):
        progressed = admit_round(tallies[-1])
        idle = 0 if progressed else idle + 1
    tallies[-1].end_queue_depth = int(
        sum(len(q) for row in pending for q in row))
    run_report, _logs = stream.finish(settle_max=settle_max)
    batches, app_pub, nulls = stream.traces()
    released = [[(np.asarray(rel_rounds[g][s], np.int64),
                  np.asarray(rel_stages[g][s], np.int64))
                 for s in range(s_max)] for g in range(g_n)]
    return build_report(batches=batches, app_pub=app_pub, nulls=nulls,
                        costs=stream.cost_params,
                        n_members=stream.n_members,
                        n_senders=stream.n_senders,
                        released=released, tallies=tallies,
                        run_report=run_report)


_DRAIN_CHUNK = 128
_TRACES = ("batch", "pub", "nulls", "release", "shed", "bl")


class _LoadPrograms:
    """The two round programs of the fused stream path, over one set of
    buffers: the profile rounds (``t < T``, arrivals from the loaded
    ``(T, G, S)`` matrix) and the drain rounds (a chunk of at most 128
    zero-arrival rounds, run while ``idle < 64`` and a queue is
    nonempty).  Each round is the EXACT host round: the policy's device
    admission -> clip -> queue arithmetic ->
    :func:`repro_torch.core.sweep.stream_stacked`, the round body
    ``GroupStream.step`` runs."""

    def __init__(self, stream, policy: AdmissionPolicy, t_prof: int,
                 mask: np.ndarray):
        g_n, s_max = stream.shape
        n_max = stream.n_max
        dev = stream.device
        group_mod.TRACE_EVENTS.append(
            ((g_n, n_max, s_max), tuple(stream.windows),
             stream.backend.name + "+load"))
        self.device = dev
        windows = stream._windows
        member_masks, sender_masks = stream._masks
        receive_fn = stream._receive
        null_send = stream._null_send
        sender_mask = torch.as_tensor(mask, device=dev)

        def z(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        pol0 = policy.device_init((g_n, s_max), dev)
        s: Dict[str, Any] = {
            "running": z(dtype=torch.bool), "t": z(), "tc": z(),
            "idle": z(), "arr": z(max(t_prof, 1), g_n, s_max),
            "states": sweep_mod.batch_states(n_max, s_max, g_n, dev),
            "backlogs": z(g_n, s_max), "pend": z(g_n, s_max),
            "pol": torch.zeros_like(pol0),
        }
        for pre, rows in (("p_", max(t_prof, 1)), ("d_", _DRAIN_CHUNK)):
            s[pre + "batch"] = z(rows, g_n, n_max)
            for k in _TRACES[1:]:
                s[pre + k] = z(rows, g_n, s_max)
        self.state = s

        def one_round(c, arr_t):
            queued = c["pend"] + arr_t
            bl_prev = torch.where(sender_mask, c["backlogs"], 0)
            release, shed, pol = policy.device_admit(
                c["pol"], queued, bl_prev, windows)
            release = torch.minimum(release.clamp(min=0), queued)
            shed = torch.minimum(shed.clamp(min=0), queued - release)
            c["pend"].copy_(queued - release - shed)
            c["pol"].copy_(pol)
            (states, backlogs), (batch, pub, nulls) = \
                sweep_mod.stream_stacked(
                    c["states"], c["backlogs"], release.to(I32),
                    windows=windows, null_send=null_send,
                    member_masks=member_masks, sender_masks=sender_masks,
                    receive_fn=receive_fn)
            for f in states.__dataclass_fields__:
                getattr(c["states"], f).copy_(getattr(states, f))
            c["backlogs"].copy_(backlogs)
            bl_now = torch.where(sender_mask, backlogs, 0)
            return batch, pub, nulls, release, shed, bl_now

        def record(c, pre, at, ys):
            for k, y in zip(_TRACES, ys):
                c[pre + k].index_copy_(0, at, y.to(I32)[None])

        def profile_round(c):
            t = c["t"]
            at = t.reshape(1).long()
            ys = one_round(c, c["arr"].index_select(0, at)[0])
            record(c, "p_", at, ys)
            t.add_(1)
            c["running"].copy_(t < t_prof)

        def drain_round(c):
            at = c["tc"].reshape(1).long()
            ys = one_round(c, torch.zeros_like(c["pend"]))
            record(c, "d_", at, ys)
            progressed = (ys[3].sum() + ys[4].sum()) > 0
            c["idle"].copy_(torch.where(progressed, 0, c["idle"] + 1))
            c["tc"].add_(1)
            c["running"].copy_(self.drain_live(c)
                               & (c["tc"] < _DRAIN_CHUNK))

        self.profile = RoundProgram(s, profile_round, dev)
        self.drain = RoundProgram(s, drain_round, dev)

    @staticmethod
    def drain_live(c) -> torch.Tensor:
        return (c["idle"] < 64) & (c["pend"].sum() > 0)

    def rows(self, pre: str, n: int) -> List[List[np.ndarray]]:
        """The first ``n`` rounds of each trace, on the host."""
        return [list(self.state[pre + k][:n].cpu().numpy())
                for k in _TRACES]


def _run_stream_profile_fused(stream, profile: Profile,
                              policy: AdmissionPolicy,
                              mask: np.ndarray,
                              stage_mats: List[np.ndarray],
                              settle_max: Optional[int]
                              ) -> Optional[LoadReport]:
    """The fused stream path: profile rounds + drain chunks on the
    device, FIFO attribution replayed on the host from the device
    release/shed matrices, rounds absorbed into the stream so
    finish/build_report run the unfused machinery verbatim.  Returns
    None (silent fallback to the host loop) when the policy has no
    device lowering."""
    if policy.fused_key() is None:
        return None
    g_n, s_max = stream.shape
    arr = np.concatenate(stage_mats, axis=0).astype(np.int32)
    t_prof = arr.shape[0]
    key = ("load-fused", g_n, stream.n_max, s_max, stream.n_members,
           stream.n_senders, tuple(stream.windows), stream._null_send,
           stream.backend.name, str(stream.device), t_prof, _DRAIN_CHUNK,
           policy.fused_key())
    progs = group_mod.fused_stream_program(
        key, lambda: _LoadPrograms(stream, policy, t_prof, mask))
    s = progs.state
    dev = progs.device
    fresh = sweep_mod.batch_states(stream.n_max, s_max, g_n, dev)
    for f in fresh.__dataclass_fields__:
        getattr(s["states"], f).copy_(getattr(fresh, f))
    for k in ("t", "tc", "idle", "backlogs", "pend"):
        s[k].zero_()
    s["arr"][:t_prof].copy_(torch.as_tensor(arr).to(dev))
    s["pol"].copy_(policy.device_init((g_n, s_max), dev))
    s["running"].fill_(t_prof > 0)
    progs.profile.run()
    cols = progs.rows("p_", t_prof)
    device_calls = 1
    while bool(progs.drain_live(s)):
        s["tc"].zero_()
        s["running"].fill_(True)
        progs.drain.run(_DRAIN_CHUNK)
        device_calls += 1
        t_c = int(s["tc"])
        for col, rows in zip(cols, progs.rows("d_", t_c)):
            col += rows
        if t_c < _DRAIN_CHUNK:
            break
    batches, pubs, nulls_l, rel_l, shed_l, bl_l = cols
    policy.device_commit(s["pol"])

    # host replay of the per-message FIFO attribution: same queues, same
    # pops, driven by the device's release/shed counts instead of a
    # policy call — depths and stage tallies land exactly where the
    # host loop puts them
    tallies: List[StageTally] = [
        StageTally(name=st.name, rounds=st.rounds, scale=st.scale)
        for st in profile.stages]
    pending: List[List[collections.deque]] = [
        [collections.deque() for _ in range(s_max)] for _ in range(g_n)]
    rel_rounds: List[List[List[int]]] = [
        [[] for _ in range(s_max)] for _ in range(g_n)]
    rel_stages: List[List[List[int]]] = [
        [[] for _ in range(s_max)] for _ in range(g_n)]
    t_global = 0

    def apply_round(tally: StageTally):
        nonlocal t_global
        rel, sh = rel_l[t_global], shed_l[t_global]
        for g, s_ in zip(*np.nonzero(rel)):
            for _ in range(int(rel[g, s_])):
                a_rnd, a_stage = pending[g][s_].popleft()
                rel_rounds[g][s_].append(a_rnd)
                rel_stages[g][s_].append(a_stage)
                tallies[a_stage].released += 1
        for g, s_ in zip(*np.nonzero(sh)):
            for _ in range(int(sh[g, s_])):
                _, a_stage = pending[g][s_].pop()  # tail drop: newest
                tallies[a_stage].shed += 1
        depth = int(sum(len(q) for row in pending for q in row))
        tally.max_queue_depth = max(tally.max_queue_depth, depth)
        bl = int(bl_l[t_global].sum())
        tally.max_stream_backlog = max(tally.max_stream_backlog, bl)
        t_global += 1

    for si, (stage, mat) in enumerate(zip(profile.stages, stage_mats)):
        tally = tallies[si]
        for t in range(stage.rounds):
            a = mat[t]
            tally.offered += int(a.sum())
            for g, s_ in zip(*np.nonzero(a)):
                pending[g][s_].extend([(t_global, si)] * int(a[g, s_]))
            apply_round(tally)
        tally.end_queue_depth = int(
            sum(len(q) for row in pending for q in row))
    while t_global < len(rel_l):
        apply_round(tallies[-1])
    tallies[-1].end_queue_depth = int(
        sum(len(q) for row in pending for q in row))

    total_rel = (np.sum(np.stack(rel_l), axis=0) if rel_l
                 else np.zeros((g_n, s_max), np.int64))
    stream.absorb(s["states"], s["backlogs"], batches, pubs, nulls_l,
                  [total_rel[g].astype(np.int64) for g in range(g_n)])
    run_report, _logs = stream.finish(settle_max=settle_max)
    batches_t, app_pub_t, nulls_t = stream.traces()
    released = [[(np.asarray(rel_rounds[g][s_], np.int64),
                  np.asarray(rel_stages[g][s_], np.int64))
                 for s_ in range(s_max)] for g in range(g_n)]
    report = build_report(batches=batches_t, app_pub=app_pub_t,
                          nulls=nulls_t, costs=stream.cost_params,
                          n_members=stream.n_members,
                          n_senders=stream.n_senders,
                          released=released, tallies=tallies,
                          run_report=run_report)
    if run_report is not None:
        run_report.extras["load_fused"] = {
            "rounds": len(batches), "profile_rounds": t_prof,
            "drain_rounds": len(batches) - t_prof,
            "device_calls": device_calls}
    return report


def _run_serve_profile(rep, profile: Profile,
                       admission: Optional[ServeAdmission], *,
                       settle_max: Optional[int],
                       max_new_tokens: int, prompt_len: int,
                       fused: bool = False) -> LoadReport:
    """The serve-plane lowering: arrival lanes are KV slots, per-round
    lane sums become request arrivals per replica; latency is request
    submit -> finish in engine rounds (the decode loop has no
    cost-model microseconds — the us percentiles report 0)."""
    from repro_torch.serve.engine import Request

    if admission is not None and not isinstance(admission,
                                                ServeAdmission):
        raise TypeError("ReplicatedEngine targets take a ServeAdmission "
                        f"policy, got {type(admission).__name__}")
    g_n = len(rep.engines)
    slots = [eng.ecfg.max_batch for eng in rep.engines]
    s_max = max(slots)
    mask = np.zeros((g_n, s_max), bool)
    for g, b in enumerate(slots):
        mask[g, :b] = True
    stage_mats = profile.matrices((g_n, s_max), mask)
    counts = np.concatenate(stage_mats, axis=0).sum(axis=2)  # (T, G)
    total_rounds = counts.shape[0]
    prompt_rng = np.random.default_rng(profile.seed + 1)
    vocab = min(eng.cfg.vocab_size for eng in rep.engines)
    schedule: List[List[List[Request]]] = [
        [[] for _ in range(g_n)] for _ in range(total_rounds)]
    rid = 0
    for t in range(total_rounds):
        for g in range(g_n):
            for _ in range(int(counts[t, g])):
                prompt = prompt_rng.integers(
                    1, max(vocab - 1, 2), size=prompt_len).astype(
                        np.int32)
                schedule[t][g].append(Request(
                    rid=rid, prompt=prompt,
                    max_new_tokens=max_new_tokens))
                rid += 1
    run_report = rep.run(
        arrive_schedule=schedule,
        arrive_rounds=total_rounds, admission=admission,
        settle_max=settle_max, fused=fused,
        max_rounds=total_rounds + 10_000)
    bounds = profile.stage_bounds()

    def stage_of(rnd: int) -> int:
        for si, (lo, hi) in enumerate(bounds):
            if lo <= rnd < hi:
                return si
        return len(bounds) - 1
    shed_rids = {r for r, _ in rep.shed_log}
    lat: List[List[float]] = [[] for _ in profile.stages]
    n = len(profile.stages)
    offered = np.zeros(n, np.int64)
    shed = np.zeros(n, np.int64)
    delivered = np.zeros(n, np.int64)
    for r, rnd in rep.submit_rounds.items():
        si = stage_of(rnd)
        offered[si] += 1
        if r in shed_rids:
            shed[si] += 1
        elif r in rep.finish_round_by_rid:
            delivered[si] += 1
            lat[si].append(rep.finish_round_by_rid[r] - rnd + 1)
    stages = []
    for si, stage in enumerate(profile.stages):
        lo, hi = bounds[si]
        depths = rep.queue_depth_log[lo:hi]
        backlogs = rep.backlog_log[lo:hi]
        if si == n - 1:                 # drain rounds land on the tail
            depths = rep.queue_depth_log[lo:]
            backlogs = rep.backlog_log[lo:]
        lr = np.asarray(lat[si], np.float64)
        stages.append(StageStats(
            name=stage.name, rounds=stage.rounds, scale=stage.scale,
            offered=int(offered[si]),
            released=int(offered[si] - shed[si]),
            shed=int(shed[si]), delivered=int(delivered[si]),
            undelivered=int(offered[si] - shed[si] - delivered[si]),
            p50_rounds=float(np.percentile(lr, 50)) if lr.size else 0.0,
            p99_rounds=float(np.percentile(lr, 99)) if lr.size else 0.0,
            p999_rounds=float(np.percentile(lr, 99.9)) if lr.size
            else 0.0,
            mean_rounds=float(lr.mean()) if lr.size else 0.0,
            p50_us=0.0, p99_us=0.0, p999_us=0.0,
            offered_per_round=float(offered[si]) / stage.rounds,
            goodput_per_round=float(delivered[si]) / stage.rounds,
            max_queue_depth=max(depths, default=0),
            max_stream_backlog=max(backlogs, default=0),
            end_queue_depth=0))
    totals = {
        "offered": int(offered.sum()), "shed": int(shed.sum()),
        "released": int(offered.sum() - shed.sum()),
        "delivered": int(delivered.sum()),
        "undelivered": int(offered.sum() - shed.sum()
                           - delivered.sum()),
        "rounds": int(total_rounds),
    }
    return LoadReport(stages=stages, totals=totals,
                      run_report=run_report)
