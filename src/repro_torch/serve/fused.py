"""Fused device-resident serve plane: decode inside the round body, one
device program per serve EPOCH.

The unfused serve plane (:meth:`repro_torch.serve.fanout.ReplicatedEngine.
run`) pays a host hop every engine round: an eager decode step whose
token ids cross to the host, Python bookkeeping, then one stacked stream
round whose watermarks cross to the host.  Here a whole serve epoch —
open-loop arrivals, admission (queue-cap tail-drop and backlog stalls),
prefill, decode, token emission, the multicast round, watermark-gated
slot reuse and the quiescence drain — runs on the device with no host
read between rounds.  Slot state, SST watermarks, backlogs, slot holds,
the arrival frontier and the admission queue live in static device
buffers; each round writes its events into preallocated trace buffers
that cross to the host once, after the epoch.

The reference builds one ``lax.while_loop`` program an epoch.  The port
captures one ROUND as a CUDA graph
(:class:`repro_torch.core.graphloop.RoundProgram`) and replays it:

* the loop condition is a device flag; the whole round sits under an IF
  node on it, and the host reads the flag once per chunk of rounds;
* ``lax.cond(serving, engine_phase, idle_phase)`` is an IF node over the
  engine phase (the idle phase's records are the buffers' reset values);
* ``lax.cond(any(admit), prefill)`` is an IF node, and inside it each
  replica's prefill and each of its P unrolled prompt positions is an IF
  node on ``p < max(prompt length of the slots it admitted)``, so a round
  pays for its longest admitted prompt only; each slot's admission
  reset is an IF node on that slot being admitted;
* the main decode of each replica is an IF node on any slot emitting.

The reference folds the G replicas' caches into one decode of G·B rows;
the port makes one decode call per replica on that engine's own cache
tensors (the graph's static buffers: nothing is copied in or out), as
its per-round loop does, so a GEMM's rows are computed at the per-round
batch size.  Every step is validity-masked with a device mask
(:mod:`repro_torch.models.masking`).  On the CPU the same round body
runs eagerly, branch for branch.

Dynamic workloads ride in the program, as in the reference:

* **open-loop arrivals** — a precomputed per-round arrival-count matrix;
  the carry tracks the arrival frontier (``avail``).  Only an arbitrary
  ``arrive_fn`` falls back.
* **admission** — ``ServeAdmission``'s queue-cap tail-drop and
  watermark stalls are carry arithmetic.
* **stall schedules** — a precomputed boolean ``(rounds, G, B)`` mask.
* **view changes (``fail_at``)** — the loop stops at the failure round,
  the host performs the cut (the same
  :meth:`ReplicatedEngine._fail_nodes`), and the next epoch's program
  runs with the ``EpochCarry`` resend as its initial backlog.

Equivalence contract (tests/test_torch_serve_fused.py): the same masked
decode body runs in both paths; the multicast rounds ARE
:func:`repro_torch.core.sweep.step_backlog` on the same ``ready`` counts,
handed to :meth:`repro_torch.core.group.GroupStream.absorb`, so report
and delivery logs come from the identical post-processing (a des
stream's program sweeps with the graph arithmetic, bit-identical to its
numpy mirror, and absorbs the rounds into numpy); holds pin and
release with the arithmetic of :meth:`ReplicatedEngine._sync_holds`; the
cut is the same host code in both paths.  What falls back to the
per-round loop is what the reference lists
(:func:`fused_fallback_reason`), with the reason in
``extras["serve"]["fused_fallback"]``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sweep as sweep_mod
from repro_torch.core.graphloop import RoundProgram, cond
from repro_torch.core.group import TRACE_EVENTS, RunReport, host_array
from repro_torch.models import masking

I32 = torch.int32


class FusedUnsupported(Exception):
    """The workload needs a feature only the per-round loop has; the
    caller falls back (explicitly, in extras) rather than fail."""


def fused_fallback_reason(rep, *, fail_at=None, arrive_fn=None,
                          arrive_schedule=None, admission=None,
                          settle_max=None) -> Optional[str]:
    """Why this run cannot take the fused path (None = it can).

    ``fail_at`` must already be wave-normalized ({round: [[nodes]]}).
    The fused program handles precomputed arrival schedules, ndarray
    stall masks, ``ServeAdmission`` policies and homogeneous ``fail_at``
    cuts in-graph; only true host callbacks, capped settles, and
    heterogeneity keep the per-round path.  The reasons are the
    reference's, word for word."""
    if arrive_fn is not None:
        return "arrive_fn: arbitrary open-loop arrivals are host callbacks"
    if rep.stall_fn is not None and not isinstance(rep.stall_fn,
                                                  np.ndarray):
        return "stall_fn: arbitrary client stalls are host callbacks"
    if isinstance(rep.stall_fn, np.ndarray):
        m = rep.stall_fn
        if m.ndim != 3 or m.shape[1] != len(rep.engines) \
                or m.shape[2] != rep.engines[0].ecfg.max_batch:
            return ("stall_fn mask must be (rounds, G, slots) boolean, "
                    f"got {m.shape}")
    if settle_max is not None:
        return "settle_max: capped settle needs the host drain loop"
    e0 = rep.engines[0]
    for eng in rep.engines:
        if (eng.cfg is not e0.cfg and eng.cfg != e0.cfg) \
                or eng.ecfg.max_batch != e0.ecfg.max_batch \
                or eng.ecfg.max_len != e0.ecfg.max_len \
                or eng.ecfg.eos_id != e0.ecfg.eos_id:
            return "heterogeneous replicas (mixed model/engine configs)"
        if eng.params is not e0.params:
            return ("replicas do not share one params tree (the fused "
                    "program folds every replica's slots into one "
                    "decode batch)")
        if any(r is not None for r in eng.slot_req):
            return "engines must start with empty slot rings"
    if fail_at:
        # Every cut must leave the replicas homogeneous — equal live
        # slot counts AND equal live subscriber counts — or the stacked
        # one-shape-per-epoch program cannot express the next epoch.
        sub_to_g = {n: g for g, t in enumerate(rep.topics)
                    for n in t.subscribers}
        dead_slots = [set() for _ in rep.engines]
        dead_subs = [set() for _ in rep.engines]
        for rnd in sorted(fail_at):
            for wave in fail_at[rnd]:
                for n in wave:
                    if n in rep._node_to_slot:
                        g, s = rep._node_to_slot[n]
                        dead_slots[g].add(s)
                    elif n in sub_to_g:
                        dead_subs[sub_to_g[n]].add(n)
                    else:
                        return (f"fail_at names node {n}, which is "
                                "neither a slot node nor a subscriber")
            if len({len(d) for d in dead_slots}) > 1 \
                    or len({len(d) for d in dead_subs}) > 1:
                return ("fail_at cut at round %d leaves heterogeneous "
                        "replicas (unequal live slot/subscriber "
                        "counts); the fused stack needs one shape per "
                        "epoch" % rnd)
    sched_reqs = [q for row in (arrive_schedule or [])
                  for cell in row for q in (cell or ())]
    all_reqs = [q for eng in rep.engines for q in eng.queue] + sched_reqs
    if not all_reqs:
        return "empty workload"
    if any(len(q.prompt) == 0 for q in all_reqs):
        return "empty prompts"
    if any(len(q.prompt) > e0.ecfg.max_len - 2
           or len(q.prompt) + q.max_new_tokens > e0.ecfg.max_len
           for q in all_reqs):
        return "request would overflow max_len mid-run"
    return None


# ---------------------------------------------------------------------------
# The one-program-per-epoch serve run
# ---------------------------------------------------------------------------

def _round_budget(n_reqs: int, slots: int, max_new: int, window: int,
                  n_members: int, max_rounds: int, *,
                  arrive_rounds: int = 0,
                  stall_slack: int = 0) -> Tuple[int, int]:
    """(serve-round cap, total cap incl. settle) — generous analytic
    bounds; a run that overflows them falls back to the unfused loop
    rather than truncate.  Open-loop runs add the arrival horizon and
    scheduled-stall slack (each stalled slot-round delays at most one
    decode round); backlog stalls self-resolve within the window
    throttle already covered per wave, doubled for slack."""
    waves = max(1, math.ceil(n_reqs / max(slots, 1)))
    per_wave = max_new + 8 + 3 * math.ceil((max_new + 1)
                                           / max(window, 1))
    serve = min(max_rounds,
                2 * waves * per_wave + arrive_rounds + stall_slack + 32)
    settle = 2 * n_members + 16 + 3 * math.ceil(
        slots * (max_new + 2) / max(window, 1))
    return serve, serve + settle


# the carry fields an epoch starts from (``init``) and ends with
_INIT_FIELDS = ("active", "held", "hold_target", "pos", "last_tok",
                "slot_rid", "emitted", "slot_max_new", "apps_enq", "avail",
                "admitted", "shed", "shed_round")
_HOST_FIELDS = ("t", "t_serve", "active", "held", "hold_target", "pos",
                "last_tok", "slot_rid", "emitted", "slot_max_new",
                "apps_enq", "avail", "admitted", "shed", "shed_round",
                "rq_head", "stall_ct", "tb_batch", "tb_pub", "tb_nulls",
                "tb_admit", "tb_tok", "tb_fin", "tb_free", "tb_backlog",
                "tb_depth")


def _build_program(engines, stream, shapes, rank_slot) -> RoundProgram:
    """Build the round program of one epoch shape (kept on the
    ``ReplicatedEngine``, one per shape).

    ``rank_slot[g]`` maps the epoch's live sender ranks to engine slots
    (identity before any cut; compacted survivors after one), baked in
    as a constant like the shapes.  Everything dynamic — the arrival
    matrix, stall mask, admission scalars, requeue list, resend backlog
    and the epoch's initial engine/queue state — is loaded into the
    program's buffers before each epoch (:func:`_load_epoch`), so a
    repeat run and every same-shape epoch reuse the program.  The
    engines' caches and the shared parameters are the decode's own
    tensors, written in place."""
    (n_g, B, S, N, window, backend, R, P, t_serve_cap, t_total,
     eos_id, max_len, T_arr, T_stall, V) = shapes
    TRACE_EVENTS.append(((n_g, N, S), (window,) * n_g,
                         backend + "+decode"))
    dev = stream.device
    params = engines[0].params
    # the round's arithmetic on the engines' device: a des stream's own
    # round is the numpy mirror, so its program sweeps with the graph
    # arithmetic (the receive override is the kernel backend's alone)
    windows = torch.as_tensor(np.asarray(stream.windows, np.int32),
                              device=dev)
    receive_fn = stream._receive

    def z(*shape, dtype=I32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    rank_slot_c = torch.as_tensor(np.asarray(rank_slot, np.int64),
                                  device=dev)                  # (G, S)
    slot_rank = np.zeros((n_g, B), np.int64)
    live_np = np.zeros((n_g, B), bool)
    for g in range(n_g):
        for r, s_ in enumerate(rank_slot[g]):
            slot_rank[g, s_] = r
            live_np[g, s_] = True
    slot_rank_c = torch.as_tensor(slot_rank, device=dev)        # (G, B)
    live_c = torch.as_tensor(live_np, device=dev)
    ranks = torch.arange(S, device=dev, dtype=I32)
    ridx_r = torch.arange(R, device=dev, dtype=I32)
    p_steps = torch.arange(P, device=dev, dtype=I32)

    s: Dict[str, Any] = {
        # operands, loaded per epoch
        "prompts": z(n_g, R, P), "prompt_len": z(n_g, R),
        "max_new": z(n_g, R), "arr_counts": z(max(T_arr, 1), n_g),
        "stall_mask": z(max(T_stall, 1), n_g, B, dtype=torch.bool),
        "requeue": z(n_g, V, fill=-1), "n_rq": z(n_g),
        "queue_cap": z(), "stall_backlog": z(), "arrive_rounds": z(),
        "t0": z(), "t_stop": z(),
        # the carry
        "running": z(dtype=torch.bool), "t": z(), "t_serve": z(),
        "states": sweep_mod.batch_states(N, S, n_g, dev),
        "backlogs": z(n_g, S),
        "active": z(n_g, B, dtype=torch.bool),
        "held": z(n_g, B, dtype=torch.bool),
        "hold_target": z(n_g, B), "hold_idx": z(n_g, B, fill=-1),
        "pos": z(n_g, B), "last_tok": z(n_g, B),
        "slot_rid": z(n_g, B, fill=-1), "emitted": z(n_g, B),
        "slot_max_new": z(n_g, B), "apps_enq": z(n_g, B),
        "avail": z(n_g), "admitted": z(n_g, R, dtype=torch.bool),
        "shed": z(n_g, R, dtype=torch.bool),
        "shed_round": z(n_g, R, fill=-1), "rq_head": z(n_g),
        "stall_ct": z(),
        # the round's event records and the decode's next tokens
        "counts": z(n_g, B), "adm_rec": z(n_g, B, fill=-1),
        "tok_rec": z(n_g, B, fill=-1),
        "fin_rec": z(n_g, B, dtype=torch.bool), "nxt": z(n_g, B),
        # per-round traces
        "tb_batch": z(t_total, n_g, N), "tb_pub": z(t_total, n_g, S),
        "tb_nulls": z(t_total, n_g, S),
        "tb_admit": z(t_total, n_g, B, fill=-1),
        "tb_tok": z(t_total, n_g, B, fill=-1),
        "tb_fin": z(t_total, n_g, B, dtype=torch.bool),
        "tb_free": z(t_total, n_g, B, dtype=torch.bool),
        "tb_backlog": z(t_total), "tb_depth": z(t_total),
        "caches": [eng.cache for eng in engines],
    }

    def take_rank(x):
        """(G, S) rank-space array -> (G, B) per-slot view (dead slots
        read lane 0 — every consumer masks them out)."""
        return torch.gather(x, 1, slot_rank_c)

    def queue_len(c, avail):
        elig = (ridx_r[None, :] < avail[:, None]) & ~c["admitted"] \
            & ~c["shed"]
        return c["n_rq"] - c["rq_head"] + elig.sum(1, dtype=I32)

    def serving_now(c):
        live = c["active"].any() | (queue_len(c, c["avail"]) > 0).any() \
            | (c["t0"] + c["t_serve"] < c["arrive_rounds"])
        return live & (c["t_serve"] < t_serve_cap)

    def sd_of(states):
        d = states.delivered_num.amin(1)                          # (G,)
        return torch.where(d[:, None] >= ranks[None, :],
                           torch.div(d[:, None] - ranks[None, :], S,
                                     rounding_mode="floor") + 1, 0)

    def engine_phase(c, elig, qlen, n_rq_pend, sched_stall, wm_stall):
        # admission: the k-th free live slot (slot order) takes the k-th
        # queued request — requeued head-of-queue entries first, then
        # eligible regulars in arrival order (ServeEngine._admit)
        active, held, rq_head = c["active"], c["held"], c["rq_head"]
        free = ~active & ~held & live_c
        order = free.to(I32).cumsum(1, dtype=I32) - 1
        admit = free & (order < qlen[:, None])
        from_rq = admit & (order < n_rq_pend[:, None])
        rq_idx = (rq_head[:, None] + order).clamp(0, V - 1).long()
        rq_ridx = torch.gather(c["requeue"], 1, rq_idx)
        j = order - n_rq_pend[:, None]                            # (G, B)
        erank = elig.to(I32).cumsum(1, dtype=I32) - 1
        sel = (elig[:, None, :] & (erank[:, None, :] == j[:, :, None])
               & admit[:, :, None] & ~from_rq[:, :, None])        # (G, B, R)
        reg_ridx = (sel.to(I32) * ridx_r[None, None, :]).sum(2, dtype=I32)
        ridx = torch.where(from_rq, rq_ridx, reg_ridx)
        safe_r = torch.where(admit, ridx, 0).long()
        c["admitted"].logical_or_(sel.any(1))
        rq_head.add_(from_rq.sum(1, dtype=I32))
        plen = torch.gather(c["prompt_len"], 1, safe_r)
        amnew = torch.gather(c["max_new"], 1, safe_r)
        pslot = torch.gather(c["prompts"], 1,
                             safe_r[:, :, None].expand(n_g, B, P))
        c["slot_rid"].copy_(torch.where(admit, ridx, c["slot_rid"]))
        c["slot_max_new"].copy_(torch.where(admit, amnew,
                                            c["slot_max_new"]))
        c["emitted"].masked_fill_(admit, 0)
        pos = c["pos"]

        # prefill: every admitted slot feeds prompt token p at position
        # p; bystanders are masked no-ops.  Rows are independent, so this
        # equals the per-round engine's sequential per-slot prefill bit
        # for bit, the admission reset included.
        def prefill():
            for g, eng in enumerate(engines):
                def prefill_replica(g=g, eng=eng):
                    cache = c["caches"][g]
                    # the admission reset, an IF node a slot
                    for b in range(B):
                        cond(admit[g, b], lambda b=b: masking.reset_slot(
                            eng.cache_specs, cache, b))
                    p_len = torch.where(admit[g], plen[g], 0).amax()
                    for p in range(P):
                        def step(p=p):
                            valid = admit[g] & (p < plen[g])
                            tokens = torch.where(valid, pslot[g, :, p],
                                                 0)[:, None]
                            posv = torch.where(admit[g], p_steps[p],
                                               pos[g])
                            eng.decode(params, cache, tokens, posv, valid)
                        cond(p_len > p, step)
                cond(admit[g].any(), prefill_replica)

        cond(admit.any(), prefill)
        pos.copy_(torch.where(admit, plen, pos))
        # the first decode input after prefill is the LAST prompt token
        # (fed once more at position P)
        lastp = torch.gather(pslot, 2, (plen - 1).clamp(min=0).long()
                             [:, :, None])[:, :, 0]
        last = c["last_tok"]
        last.copy_(torch.where(admit, lastp, last))
        active.logical_or_(admit)
        # stalls bind AFTER admission (a stalled slot still admits and
        # prefills — ServeEngine.step's ordering); stalled occupied slots
        # count, then sit out the decode
        stall_now = (sched_stall | wm_stall) & active
        c["stall_ct"].add_(stall_now.sum(dtype=I32))
        emit = active & ~stall_now

        # main decode: one masked step for each replica's whole ring
        tokens = torch.where(emit, last, 0)
        nxt = c["nxt"]
        for g, eng in enumerate(engines):
            def decode(g=g, eng=eng):
                logits, _ = eng.decode(params, c["caches"][g],
                                       tokens[g][:, None], pos[g],
                                       emit[g])
                nxt[g].copy_(torch.argmax(logits.float(), dim=-1))
            cond(emit[g].any(), decode)
        last.copy_(torch.where(emit, nxt, last))
        emitted = c["emitted"]
        emitted.add_(emit.to(I32))
        pos.add_(emit.to(I32))
        done = emitted >= c["slot_max_new"]
        if eos_id is not None:
            done = done | (nxt == eos_id)
        fin = emit & (done | (pos >= max_len - 1))
        active.logical_and_(~fin)
        pos.masked_fill_(fin, 0)
        counts = admit.to(I32) + emit.to(I32)
        c["apps_enq"].add_(counts)
        # finished slots hold until the delivery watermark passes their
        # last enqueued app (the SMC slot-reuse rule)
        held.logical_or_(fin)
        c["hold_target"].copy_(torch.where(fin, c["apps_enq"],
                                           c["hold_target"]))
        c["hold_idx"].masked_fill_(fin, -1)
        c["counts"].copy_(counts)
        c["adm_rec"].copy_(torch.where(admit, ridx, -1))
        c["tok_rec"].copy_(torch.where(emit, nxt, -1))
        c["fin_rec"].copy_(fin)

    def round_fn(c):
        serving = serving_now(c)
        t = c["t"]
        t_g = c["t0"] + t
        at = t.reshape(1).long()

        # open-loop arrivals: the schedule row advances the frontier
        # (inert past the horizon and during settle)
        row = t_g.clamp(0, max(T_arr, 1) - 1).reshape(1).long()
        arr = torch.where(t_g < T_arr,
                          c["arr_counts"].index_select(0, row)[0], 0)
        avail = c["avail"] + arr
        elig = (ridx_r[None, :] < avail[:, None]) & ~c["admitted"] \
            & ~c["shed"]                                          # (G, R)
        n_rq_pend = c["n_rq"] - c["rq_head"]
        qlen = n_rq_pend + elig.sum(1, dtype=I32)

        # admission queue-cap: shed the tail (newest first), as the host
        # loop's `while len(queue) > cap: queue.pop()`
        over = (qlen - c["queue_cap"]).clamp(min=0)
        rev = elig.flip(1).to(I32).cumsum(1, dtype=I32).flip(1)
        shed_new = elig & (rev <= over[:, None])
        c["shed"].logical_or_(shed_new)
        c["shed_round"].copy_(torch.where(shed_new, t_g,
                                          c["shed_round"]))
        elig = elig & ~shed_new
        qlen = qlen - shed_new.sum(1, dtype=I32)
        depth = qlen.sum(dtype=I32)
        c["avail"].copy_(avail)

        # stalls: the schedule row plus the watermark stall — a lane whose
        # published-undelivered + backlog inflight (the previous round's
        # watermarks) exceeds stall_backlog; t > 0 gates it like the
        # host loop's first round of an epoch
        srow = t_g.clamp(0, max(T_stall, 1) - 1).reshape(1).long()
        sched_stall = (c["stall_mask"].index_select(0, srow)[0]
                       & (t_g < T_stall))
        old = c["states"]
        inflight = old.published - sd_of(old) + c["backlogs"]     # (G, S)
        wm_stall = (take_rank(inflight) > c["stall_backlog"]) & (t > 0)

        # engine phase, skipped on settle rounds (whose records are the
        # idle ones set here)
        c["counts"].zero_()
        c["adm_rec"].fill_(-1)
        c["tok_rec"].fill_(-1)
        c["fin_rec"].zero_()
        cond(serving, lambda: engine_phase(c, elig, qlen, n_rq_pend,
                                           sched_stall, wm_stall))

        # multicast sweep: the stream's round body on the live sender
        # ranks (compacted slot order)
        counts_rank = torch.gather(c["counts"], 1, rank_slot_c)
        (states, backlogs), (batch, pub, nulls) = sweep_mod.stream_stacked(
            old, c["backlogs"], counts_rank, windows=windows,
            null_send=True, receive_fn=receive_fn)

        # holds: pin at the k-th app's publish index, release on the
        # watermark (ReplicatedEngine._sync_holds, gathered from rank
        # space into slot space)
        held, target, hidx = c["held"], c["hold_target"], c["hold_idx"]
        crossed = held & (hidx < 0) & (target > 0) \
            & (take_rank(states.app_sent) >= target)
        pin = take_rank(old.published) + (target - take_rank(old.app_sent)) \
            - 1
        hidx.copy_(torch.where(crossed, pin, hidx))
        freed = held & (hidx >= 0) & (take_rank(sd_of(states)) > hidx)
        held.logical_and_(~freed)

        c["tb_batch"].index_copy_(0, at, batch[None])
        c["tb_pub"].index_copy_(0, at, pub[None])
        c["tb_nulls"].index_copy_(0, at, nulls[None])
        c["tb_admit"].index_copy_(0, at, c["adm_rec"][None])
        c["tb_tok"].index_copy_(0, at, c["tok_rec"][None])
        c["tb_fin"].index_copy_(0, at, c["fin_rec"][None])
        c["tb_free"].index_copy_(0, at, freed[None])
        c["tb_backlog"].index_copy_(0, at, backlogs.sum(dtype=I32)
                                    .reshape(1))
        c["tb_depth"].index_copy_(0, at, depth.reshape(1))
        for f in old.__dataclass_fields__:
            getattr(old, f).copy_(getattr(states, f))
        c["backlogs"].copy_(backlogs)
        t.add_(1)
        c["t_serve"].add_(serving.to(I32))
        c["running"].copy_(loop_cond(c))

    def loop_cond(c):
        q = sweep_mod.quiescent_stacked(c["states"], c["backlogs"])
        return (c["t"] < t_total) & (c["t_serve"] < c["t_stop"]) \
            & (serving_now(c) | ~q)

    prog = RoundProgram(s, round_fn, dev)
    prog.loop_cond = loop_cond
    return prog


def _load_epoch(prog: RoundProgram, ops: Dict[str, Any],
                init: Dict[str, np.ndarray], backlogs0: np.ndarray) -> None:
    """Copy one epoch's operands and initial carry into the program's
    buffers, reset the round counters and traces, and set the loop
    flag."""
    s = prog.state
    dev = prog.device

    def put(name, value):
        s[name].copy_(torch.as_tensor(np.asarray(value)).to(
            dev, s[name].dtype))

    for k, v in ops.items():
        put(k, v)
    for k in _INIT_FIELDS:
        put(k, init[k])
    put("backlogs", backlogs0)
    fresh = sweep_mod.batch_states(s["states"].delivered_num.shape[-1],
                                   s["states"].published.shape[-1],
                                   s["backlogs"].shape[0], dev)
    for f in fresh.__dataclass_fields__:
        getattr(s["states"], f).copy_(getattr(fresh, f))
    for k in ("t", "t_serve", "rq_head", "stall_ct", "tb_batch", "tb_pub",
              "tb_nulls", "tb_fin", "tb_free", "tb_backlog", "tb_depth"):
        s[k].zero_()
    for k in ("hold_idx", "tb_admit", "tb_tok"):
        s[k].fill_(-1)
    s["running"].copy_(prog.loop_cond(s))


def _owner_fill(tb_admit: np.ndarray, init_rid: np.ndarray) -> np.ndarray:
    """Per-(round, replica, slot) owning request index: one vectorized
    forward-fill of the last admission at or before each round over the
    whole ``tb_admit`` buffer.  Rounds before a slot's first in-epoch
    admission fall back to ``init_rid`` — the request occupying the slot
    when the epoch began (-1 if idle)."""
    t_n = tb_admit.shape[0]
    if t_n == 0:
        return np.zeros_like(tb_admit)
    idx = np.where(tb_admit >= 0, np.arange(t_n)[:, None, None], -1)
    last = np.maximum.accumulate(idx, axis=0)
    own = np.take_along_axis(tb_admit, np.maximum(last, 0), axis=0)
    return np.where(last >= 0, own, init_rid[None].astype(tb_admit.dtype))


def run_fused(rep, *, max_rounds: int = 10_000, fail_at=None,
              arrive_schedule=None, arrive_rounds: int = 0,
              admission=None) -> Optional[RunReport]:
    """Execute one serve run of ``rep`` (a
    :class:`repro_torch.serve.fanout.ReplicatedEngine`) as one device
    program per membership epoch, then reconstruct the engines' and
    fan-out's host state from the device round traces so callers see
    exactly what the per-round loop would have produced.

    ``fail_at`` must be wave-normalized.  With cuts scheduled, the loop
    stops at each failure round, the host performs the cut through the
    SAME :meth:`ReplicatedEngine._fail_nodes` the unfused loop uses, and
    the next epoch runs a fused program with the ``EpochCarry`` resend as
    its initial backlog.

    Returns None when the FIRST epoch overflows the analytic round
    budget (the caller falls back to the unfused loop — the host state is
    untouched until the first reconstruction, and the decode caches hold
    nothing a later admission reads before it rewrites it).  A later
    epoch overflowing raises RuntimeError: the run is already partially
    applied.  Raises :class:`FusedUnsupported` for unsupported workload
    shapes."""
    from repro_torch.serve.fanout import _SlotHold

    engines = rep.engines
    e0 = engines[0]
    if any(eng.device != rep.device for eng in engines):
        raise ValueError(
            f"the fused program runs the engines ({e0.device}) and their "
            f"multicast ({rep.device}) on one device")
    n_g, B = len(engines), e0.ecfg.max_batch
    subs = len(rep.topics[0].subscribers)
    fail_at = dict(fail_at or {})

    # ---- the request universe: initial queues + the truncated arrival
    # schedule, in arrival order (index order == FIFO order) ------------
    n_init = [len(eng.queue) for eng in engines]
    reqs = [list(eng.queue) for eng in engines]
    sched = list(arrive_schedule or [])
    if sched and arrive_rounds <= 0:
        arrive_rounds = len(sched)
    t_arr = min(len(sched), arrive_rounds) if sched else 0
    arr_counts = np.zeros((max(t_arr, 1), n_g), np.int32)
    arrive_at: List[Tuple[int, int]] = []    # (rid, round submitted)
    for rnd in range(t_arr):
        row = sched[rnd]
        for g in range(n_g):
            cell = list(row[g]) if row[g] else []
            arr_counts[rnd, g] = len(cell)
            for q in cell:
                reqs[g].append(q)
                arrive_at.append((q.rid, rnd))
    r_max = max(len(r) for r in reqs)
    if r_max == 0:
        raise FusedUnsupported("empty workload")
    p_max = max(len(q.prompt) for r in reqs for q in r)
    m_max = max(q.max_new_tokens for r in reqs for q in r)
    rid_to_idx = [{q.rid: i for i, q in enumerate(reqs[g])}
                  for g in range(n_g)]

    stalls = rep.stall_fn if isinstance(rep.stall_fn, np.ndarray) \
        else None
    t_stall = int(stalls.shape[0]) if stalls is not None else 0
    stall_mask = np.zeros((max(t_stall, 1), n_g, B), bool)
    if stalls is not None:
        stall_mask[:t_stall] = stalls.astype(bool)

    big = np.int32(2 ** 30)
    q_cap = big if admission is None or admission.queue_cap is None \
        else np.int32(admission.queue_cap)
    s_backlog = big if admission is None \
        or admission.stall_backlog is None \
        else np.int32(admission.stall_backlog)

    # the stream first: its substrate is what the program sweeps on
    bound = rep.domain.bind(backend=rep.backend, device=rep.device)
    stream = bound.stream
    if stream._masks[0] is not None:
        raise FusedUnsupported(
            "heterogeneous topic shapes (padded stack) — fused "
            "path needs a homogeneous slot ring")
    if not stream.group.cfg.flags.null_send:
        raise FusedUnsupported(
            "null_send disabled: the in-graph drain may never "
            "quiesce")
    window = rep.topics[0].window
    if stream.windows[0] != window:
        raise FusedUnsupported(
            "topic window disagrees with the bound stream's "
            "protocol window")

    rep._reset_run_state()
    t_serve_cap, t_total = _round_budget(
        r_max, B, m_max, window, B + subs, max_rounds,
        arrive_rounds=arrive_rounds, stall_slack=int(stall_mask.sum()))
    wall0 = time.perf_counter()
    now = time.time()
    tok0 = sum(len(r.tokens_out) for eng in engines
               for r in eng.completed)
    req0 = sum(len(eng.completed) for eng in engines)
    steps0 = sum(e.decode_steps for e in engines)

    # ---- host-side run accumulators ----------------------------------
    depth_all: List[int] = []
    backlog_all: List[int] = []
    birth = np.full((n_g, B), -1, np.int64)   # current hold's fin round
    prev_shed = np.zeros((n_g, r_max), bool)
    stall_total = 0
    fused_rounds = 0
    epochs_run = 0

    # epoch-1 initial state: everything idle, identity rank map
    init = {
        "active": np.zeros((n_g, B), bool),
        "held": np.zeros((n_g, B), bool),
        "hold_target": np.zeros((n_g, B), np.int32),
        "pos": np.zeros((n_g, B), np.int32),
        "last_tok": np.zeros((n_g, B), np.int32),
        "slot_rid": np.full((n_g, B), -1, np.int32),
        "emitted": np.zeros((n_g, B), np.int32),
        "slot_max_new": np.zeros((n_g, B), np.int32),
        "apps_enq": np.zeros((n_g, B), np.int32),
        "avail": np.asarray(n_init, np.int32),
        "admitted": np.zeros((n_g, r_max), bool),
        "shed": np.zeros((n_g, r_max), bool),
        "shed_round": np.full((n_g, r_max), -1, np.int32),
    }
    requeue = np.full((n_g, 1), -1, np.int32)
    n_rq = np.zeros(n_g, np.int32)
    backlogs0 = np.zeros((n_g, B), np.int32)
    t0 = 0
    pending = deque(sorted(fail_at))
    prompts = _pad_prompts(reqs, n_g, r_max, p_max)
    prompt_len = _req_field(reqs, n_g, r_max, lambda q: len(q.prompt))
    max_new = _req_field(reqs, n_g, r_max, lambda q: q.max_new_tokens)

    while True:
        rank_slot = [list(r) for r in rep._rank_slot]
        s_live = len(rank_slot[0])
        if any(len(r) != s_live for r in rank_slot):
            raise FusedUnsupported(
                "cut left replicas with unequal live slot counts")
        if stream._masks[0] is not None:
            raise RuntimeError(
                "fused epoch after a cut has heterogeneous topic "
                "shapes; the fallback precheck should have caught "
                "this")
        n_live = stream.n_members[0]
        if stream.n_senders[0] != s_live:
            raise RuntimeError(
                f"stream sender count {stream.n_senders[0]} disagrees "
                f"with live slot count {s_live} after the cut")
        nxt_fail = pending[0] if pending else None
        t_stop = (nxt_fail - t0 + 1) if nxt_fail is not None else t_total
        v_cap = max(1, requeue.shape[1])

        shapes = (n_g, B, s_live, n_live, window, rep.backend, r_max,
                  p_max, t_serve_cap, t_total, e0.ecfg.eos_id,
                  e0.ecfg.max_len, t_arr, t_stall, v_cap)
        # the program closes over the engines' parameters and caches
        # (written in place for an engine's whole life): it is kept on
        # ``rep`` and freed with it
        key = ("serve-fused", repr(e0.cfg), repr(e0.rt), str(rep.device),
               shapes, tuple(tuple(r) for r in rank_slot))
        program = rep._fused_programs.get(key)
        if program is None:
            program = rep._fused_programs[key] = _build_program(
                engines, stream, shapes, rank_slot)
        _load_epoch(program, {
            "prompts": prompts, "prompt_len": prompt_len,
            "max_new": max_new, "arr_counts": arr_counts,
            "stall_mask": stall_mask, "requeue": requeue, "n_rq": n_rq,
            "queue_cap": q_cap, "stall_backlog": s_backlog,
            "arrive_rounds": arrive_rounds, "t0": t0, "t_stop": t_stop,
        }, init, backlogs0[:, :s_live])
        program.run()
        epochs_run += 1
        s = program.state
        host = {k: s[k].cpu().numpy() for k in _HOST_FIELDS}
        t_end = int(host["t"])
        t_serve = int(host["t_serve"])
        wedged = nxt_fail is not None and t_serve >= t_stop
        if not wedged:
            qleft = int(n_rq.sum()) - int(host["rq_head"].sum()) + int(
                ((np.arange(r_max)[None, :] < host["avail"][:, None])
                 & ~host["admitted"] & ~host["shed"]).sum())
            live = host["active"].any() or qleft > 0
            overflow = (live and t_serve < max_rounds) or (
                t_end >= t_total and not bool(
                    sweep_mod.quiescent_stacked(s["states"],
                                                s["backlogs"])))
            if overflow:
                if epochs_run == 1:
                    return None      # budget overflow: fall back clean
                raise RuntimeError(
                    "fused epoch %d overflowed its round budget "
                    "mid-run (t=%d, budget=%d); raise max_rounds or "
                    "run unfused" % (epochs_run, t_end, t_total))

        # ---- per-epoch host reconstruction (one crossing per epoch) --
        stall_total += int(host["stall_ct"])
        fused_rounds += t_end
        birth = _apply_epoch(
            rep, reqs, host, s, t0, t_serve, t_end, rank_slot, stream,
            now, birth, prev_shed, depth_all, backlog_all)
        prev_shed = host["shed"].copy()
        _materialize_engines(rep, reqs, host, requeue, n_rq, _SlotHold,
                             birth)

        if not wedged:
            break

        # ---- the wedge: the host performs the cut, the next epoch runs
        # a fused program with the resend as its backlog ----------------
        pending.popleft()
        bound = rep._fail_nodes(bound, fail_at[nxt_fail], nxt_fail,
                                admission)
        stream = bound.stream
        t0 = nxt_fail + 1
        init = _epoch_init(rep, reqs, rid_to_idx, host, n_g, B, r_max)
        requeue, n_rq = _requeue_ops(rep, rid_to_idx,
                                     host["admitted"], n_g)
        backlogs0 = host_array(stream._backlogs).astype(np.int32)
        birth = _hold_births(rep, birth, n_g, B)

    # ---- finish: settle already ran on the device; post-process -------
    total_serve = t0 + t_serve
    unreached = sorted(r for r in fail_at if r >= total_serve)
    report, logs = bound.finish()
    rep.queue_depth_log = list(depth_all)
    rep.backlog_log = list(backlog_all)
    rep.stall_rounds = stall_total
    wall = time.perf_counter() - wall0
    tokens = sum(len(r.tokens_out) for eng in engines
                 for r in eng.completed) - tok0
    report.extras["delivery_logs"] = logs
    report.extras["serve"] = {
        "replicas": n_g,
        "engine_rounds": total_serve,
        "drained": all(eng.drained() for eng in engines),
        "decode_steps": sum(e.decode_steps
                            for e in engines) - steps0,
        "requests": sum(len(e.completed) for e in engines) - req0,
        "tokens": tokens,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "stall_rounds": stall_total,
        "held_slots": sum(len(h) for h in rep._holds),
        "view_changes": len(rep.view_log),
        "slot_failures": len(rep.slot_failures),
        "voided_requests": sum(1 for r in rep.slot_failures
                               if r["voided_rid"] is not None),
        "requeued_requests": sum(1 for r in rep.slot_failures
                                 if r["requeued"]),
        "slot_failure_log": list(rep.slot_failures),
        "fail_at_unreached": unreached,
        "shed_requests": len(rep.shed_log),
        # per-RUN maxima over THIS run's logs
        "max_queue_depth": max(depth_all, default=0),
        "max_backlog": max(backlog_all, default=0),
        "wall_s": wall,
        "fused": True,
        "host_hops": 0,
        "fused_rounds": fused_rounds,
        "fused_round_budget": t_total,
        "fused_epochs": epochs_run,
    }
    for rid, rnd in arrive_at:
        rep.submit_rounds[rid] = rnd
    rep.last_report = report
    return report


# ---------------------------------------------------------------------------
# Host-side epoch reconstruction (numpy, as the reference's)
# ---------------------------------------------------------------------------

def _req_field(reqs, n_g, r_max, fn):
    arr = np.zeros((n_g, r_max), np.int32)
    for g, rs in enumerate(reqs):
        for i, q in enumerate(rs):
            arr[g, i] = fn(q)
    return arr


def _pad_prompts(reqs, n_g, r_max, p_max):
    prompts = np.zeros((n_g, r_max, p_max), np.int32)
    for g, rs in enumerate(reqs):
        for i, q in enumerate(rs):
            prompts[g, i, :len(q.prompt)] = np.asarray(q.prompt,
                                                       np.int32)
    return prompts


def _apply_epoch(rep, reqs, host, state, t0, t_serve, t_end, rank_slot,
                 stream, now, birth, prev_shed, depth_all, backlog_all):
    """Replay one epoch's device traces into the fan-out's host state —
    tokens, completions, admission/finish/free/shed bookkeeping, the
    depth/backlog logs — and absorb the multicast rounds into the bound
    stream.  Returns the updated per-slot hold-birth rounds (used to
    keep free_rounds in the host loop's hold-insertion order)."""
    engines = rep.engines
    n_g = len(engines)
    tb = {k: host[k][:t_end] for k in
          ("tb_batch", "tb_pub", "tb_nulls", "tb_admit", "tb_tok",
           "tb_fin", "tb_free", "tb_backlog", "tb_depth")}
    counts = (tb["tb_admit"] >= 0).astype(np.int64) \
        + (tb["tb_tok"] >= 0).astype(np.int64)          # (T, G, B)
    stream.absorb(
        state["states"], state["backlogs"], list(tb["tb_batch"]),
        list(tb["tb_pub"]), list(tb["tb_nulls"]),
        [counts[:, g, :].sum(axis=0)[np.asarray(rank_slot[g])]
         for g in range(n_g)])

    # a slot's owner before its first in-epoch admission is the engine's
    # slot_req at epoch entry (written as reqs indices last epoch; every
    # slot starts idle in the first)
    start_rid = np.full(host["slot_rid"].shape, -1, np.int64)
    for g, eng in enumerate(engines):
        for s, q in enumerate(eng.slot_req):
            if q is not None:
                start_rid[g, s] = _rid_index(reqs, g, q)
    own = _owner_fill(tb["tb_admit"], start_rid)

    # admissions: bookkeeping + prefill decode steps
    for t, g, s in zip(*np.nonzero(tb["tb_admit"] >= 0)):
        i = int(tb["tb_admit"][t, g, s])
        req = reqs[g][i]
        rep.admit_rounds[req.rid] = t0 + int(t)
        rep.admit_slots[req.rid] = (g, int(s))
        engines[g].decode_steps += len(req.prompt)
        req.tokens_out = []     # (re-)admission restarts from prompt

    # tokens, in round order (np.nonzero is t-major)
    for t, g, s in zip(*np.nonzero(tb["tb_tok"] >= 0)):
        reqs[g][own[t, g, s]].tokens_out.append(
            int(tb["tb_tok"][t, g, s]))

    # finishes: completion append order is (round, slot) per replica —
    # the per-round loop's order
    fins = sorted((int(t), int(g), int(s))
                  for t, g, s in zip(*np.nonzero(tb["tb_fin"])))
    for t, g, s in fins:
        req = reqs[g][own[t, g, s]]
        req.finished_at = now
        rep.finish_round_by_rid[req.rid] = t0 + t
        engines[g].completed.append(req)
        rep.finish_rounds.append((g, s, t0 + t))

    # sheds: round ascending, replica ascending, newest (highest
    # arrival index) first — the host loop's tail-pop order
    new_shed = host["shed"] & ~prev_shed
    evs = []
    for g in range(n_g):
        for i in np.nonzero(new_shed[g])[0]:
            evs.append((int(host["shed_round"][g, i]), g, -int(i)))
    for rnd, g, ni in sorted(evs):
        rep.shed_log.append((reqs[g][-ni].rid, rnd))

    # frees: serve-round frees at their round; settle-round frees all
    # land in the single post-finish sync at round t_serve, ordered by
    # hold creation (finish round, slot) per replica
    frees = []
    for t, g, s in zip(*np.nonzero(tb["tb_free"])):
        t, g, s = int(t), int(g), int(s)
        f_ts = [t0 + ft for (ft, gg, ss) in fins
                if gg == g and ss == s and ft <= t]
        b = max(f_ts) if f_ts else int(birth[g, s])
        frees.append((t0 + min(t, t_serve), g, b, s))
    for t, g, _b, s in sorted(frees):
        rep.free_rounds.append((g, s, t))

    # per-engine counters + run logs
    for g, eng in enumerate(engines):
        eng.rounds += t_serve
        eng.decode_steps += int(
            (tb["tb_tok"][:, g] >= 0).any(axis=1).sum())
        rep._apps_enqueued[g][:] = host["apps_enq"][g]
    depth_all.extend(int(x) for x in tb["tb_depth"][:t_serve])
    backlog_all.extend(int(x) for x in tb["tb_backlog"][:t_serve])

    # updated hold births: a held slot's current hold was created at
    # its last finish (this epoch, else carried from before)
    new_birth = birth.copy()
    for t, g, s in fins:
        new_birth[g, s] = t0 + t
    return new_birth


def _rid_index(reqs, g, q) -> int:
    for i, r in enumerate(reqs[g]):
        if r is q:
            return i
    raise KeyError(f"request rid={q.rid} not in replica {g}'s universe")


def _materialize_engines(rep, reqs, host, requeue, n_rq, slot_hold_cls,
                         birth):
    """Install the epoch-end carry as host engine/queue/hold state, so
    the cut (and the caller, after the final epoch) sees exactly what
    the per-round loop would have left behind."""
    for g, eng in enumerate(rep.engines):
        b = eng.ecfg.max_batch
        eng.slot_req = [None] * b
        eng.slot_len[:] = 0
        for s in range(b):
            if host["active"][g, s]:
                eng.slot_req[s] = reqs[g][int(host["slot_rid"][g, s])]
                eng.slot_len[s] = int(host["pos"][g, s])
        pend = [int(x) for x in
                requeue[g, int(host["rq_head"][g]):int(n_rq[g])]]
        elig = [i for i in range(int(host["avail"][g]))
                if not host["admitted"][g, i]
                and not host["shed"][g, i]]
        eng.queue = deque(reqs[g][i] for i in pend + elig)
        holds = {}
        order = sorted((int(birth[g, s]), s) for s in range(b)
                       if host["held"][g, s])
        for b_rnd, s in order:     # insertion order = creation order
            holds[s] = slot_hold_cls(
                target_apps=int(host["hold_target"][g, s]),
                last_idx=None, finished_round=max(b_rnd, 0))
        rep._holds[g] = holds


def _epoch_init(rep, reqs, rid_to_idx, host, n_g, b, r_max):
    """Build the next epoch's initial engine/queue carry from the
    post-cut host state (evictions, hold rebasing and re-queueing
    already applied by :meth:`ReplicatedEngine._fail_nodes`)."""
    init = {
        "active": np.zeros((n_g, b), bool),
        "held": np.zeros((n_g, b), bool),
        "hold_target": np.zeros((n_g, b), np.int32),
        "pos": np.zeros((n_g, b), np.int32),
        "last_tok": np.zeros((n_g, b), np.int32),
        "slot_rid": np.full((n_g, b), -1, np.int32),
        "emitted": np.zeros((n_g, b), np.int32),
        "slot_max_new": np.zeros((n_g, b), np.int32),
        "apps_enq": np.zeros((n_g, b), np.int32),
        "avail": host["avail"].astype(np.int32),
        "admitted": host["admitted"].copy(),
        "shed": host["shed"].copy(),
        "shed_round": host["shed_round"].astype(np.int32),
    }
    for g, eng in enumerate(rep.engines):
        for s in range(b):
            q = eng.slot_req[s]
            if q is not None:
                i = rid_to_idx[g][q.rid]
                init["active"][g, s] = True
                init["slot_rid"][g, s] = i
                init["pos"][g, s] = int(eng.slot_len[s])
                init["last_tok"][g, s] = (
                    q.tokens_out[-1] if q.tokens_out
                    else int(q.prompt[-1]))
                init["emitted"][g, s] = len(q.tokens_out)
                init["slot_max_new"][g, s] = q.max_new_tokens
        for s, hold in rep._holds[g].items():
            init["held"][g, s] = True
            init["hold_target"][g, s] = hold.target_apps
        init["apps_enq"][g, :] = rep._apps_enqueued[g]
    return init


def _requeue_ops(rep, rid_to_idx, admitted, n_g):
    """The post-cut head-of-queue re-admission list per replica: the
    queue's leading already-ADMITTED entries (a voided request the cut
    pushed back via ``appendleft``), which must admit before any
    eligible regular — regulars are never marked admitted while still
    queued, so the admitted flag is exactly the requeue marker."""
    rq: List[List[int]] = []
    for g, eng in enumerate(rep.engines):
        lst = []
        for q in eng.queue:
            i = rid_to_idx[g][q.rid]
            if not admitted[g, i]:
                break
            lst.append(i)
        rq.append(lst)
    v = max(1, max((len(r) for r in rq), default=1))
    arr = np.full((n_g, v), -1, np.int32)
    n = np.zeros(n_g, np.int32)
    for g, lst in enumerate(rq):
        arr[g, :len(lst)] = lst
        n[g] = len(lst)
    return arr, n


def _hold_births(rep, birth, n_g, b):
    """Clear birth rounds of slots whose hold the cut dropped/freed."""
    out = birth.copy()
    for g in range(n_g):
        for s in range(b):
            if s not in rep._holds[g]:
                out[g, s] = -1
    return out
