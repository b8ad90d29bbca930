"""Per-message tail-latency accounting from round traces
(DESIGN.md Sec. 10).

The protocol backends don't timestamp individual messages — they emit
round traces: per-round per-sender app publishes (``app_pub``), nulls,
and per-round per-member delivery counts (``batches``).  Those traces
determine every message's life exactly, because the total order is
round-robin arithmetic:

* sender ``s``'s ``j``-th app message (FIFO — released order IS publish
  order, messages are indistinguishable counts) publishes in the round
  where its per-sender app cumsum reaches ``j+1``; its publish index
  among the sender's apps+nulls places it at total-order seq
  ``index * S + s``;
* it is DELIVERED EVERYWHERE in the first round where every real
  member's delivered watermark (``cumsum(batches) - 1``) reaches that
  seq.

Latency is measured from the message's open-loop ARRIVAL round (when
the workload generated it), not its publish round — so it includes
admission queueing and SMC window throttling.  That is the honest
open-loop number: a closed-loop measurement from publish round would
hide exactly the queueing that saturation causes.  Round-granular
latencies convert to microseconds through the same calibrated cost fold
the backends charge (:func:`repro_torch.core.group.fold_cost_np`).

Reported per stage: p50/p99/p999/mean latency (rounds and us), offered
vs goodput (messages per round), shed and undelivered counts, and peak
queue depth / stream backlog — goodput and offered load are SEPARATE
columns, never conflated.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.group import RunReport, fold_cost_np


def sender_app_timeline(app_pub_s: np.ndarray, nulls_s: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One sender's (T,) app/null publish trace -> per app message
    ``(publish_round, publish_index)`` arrays, publish index counting
    apps AND nulls (apps precede nulls within a round, matching the
    sweep's ``published + app_pub + nulls`` ordering and
    :meth:`repro_torch.core.group.GroupStream.app_publish_index`)."""
    a = np.asarray(app_pub_s, np.int64)
    nl = np.asarray(nulls_s, np.int64)
    app_cum = np.cumsum(a)
    tot_start = np.cumsum(a + nl) - (a + nl)      # pubs before the round
    app_start = app_cum - a                       # apps before the round
    rounds = np.repeat(np.arange(a.shape[0]), a)  # (K,) publish rounds
    j = np.arange(int(app_cum[-1]) if a.size else 0)
    idx = tot_start[rounds] + (j - app_start[rounds])
    return rounds, idx


def delivered_watermark(batches_g: np.ndarray, n_members: int
                        ) -> np.ndarray:
    """(T, N) per-round delivery counts -> (T,) highest total-order seq
    delivered at EVERY real member by the end of each round."""
    if batches_g.shape[0] == 0:
        return np.zeros(0, np.int64)
    per_member = np.cumsum(batches_g[:, :n_members], axis=0) - 1
    return per_member.min(axis=1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class StageStats:
    """One profile stage's accounting.  ``offered`` counts every
    open-loop arrival in the stage; ``released`` those admission let
    into the stream; ``shed`` those admission dropped; ``delivered``
    the released messages that reached every member by the end of the
    run (``undelivered`` = released - delivered, nonzero only when the
    drain was capped).  Latency percentiles cover delivered messages
    that ARRIVED in this stage, measured arrival -> delivered-everywhere."""

    name: str
    rounds: int
    scale: float
    offered: int
    released: int
    shed: int
    delivered: int
    undelivered: int
    p50_rounds: float
    p99_rounds: float
    p999_rounds: float
    mean_rounds: float
    p50_us: float
    p99_us: float
    p999_us: float
    offered_per_round: float
    goodput_per_round: float
    max_queue_depth: int
    max_stream_backlog: int
    end_queue_depth: int

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LoadReport:
    """What a profile run measured: per-stage stats plus the protocol's
    own :class:`~repro_torch.core.group.RunReport` for the whole session."""

    stages: List[StageStats]
    totals: Dict[str, float]
    run_report: Optional[RunReport] = None

    def stage(self, name: str) -> StageStats:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"no stage {name!r}; have "
                       f"{[s.name for s in self.stages]}")

    def to_json(self) -> Dict:
        return {"stages": [s.to_json() for s in self.stages],
                "totals": dict(self.totals)}

    def json_str(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)


def _pct(arr: np.ndarray, q: float) -> float:
    return float(np.percentile(arr, q)) if arr.size else 0.0


@dataclasses.dataclass
class StageTally:
    """Harness-side per-stage counters accumulated while driving."""

    name: str
    rounds: int
    scale: float
    offered: int = 0
    released: int = 0
    shed: int = 0
    max_queue_depth: int = 0
    max_stream_backlog: int = 0
    end_queue_depth: int = 0


def build_report(*, batches: np.ndarray, app_pub: np.ndarray,
                 nulls: np.ndarray, costs: np.ndarray,
                 n_members: Sequence[int], n_senders: Sequence[int],
                 released: Sequence[Sequence[Tuple[np.ndarray,
                                                   np.ndarray]]],
                 tallies: Sequence[StageTally],
                 run_report: Optional[RunReport] = None) -> LoadReport:
    """Reconstruct per-message latencies from the stacked round traces
    and fold them into per-stage stats.

    ``released[g][s]`` is ``(arrival_rounds, stage_idx)`` arrays for the
    lane's released messages in release (= publish) order; ``tallies``
    carries the harness-side counters the traces can't know (offered,
    shed, queue depths)."""
    g_n, t_n = app_pub.shape[0], app_pub.shape[1]
    n_stages = len(tallies)
    lat_rounds: List[List[np.ndarray]] = [[] for _ in range(n_stages)]
    lat_us: List[List[np.ndarray]] = [[] for _ in range(n_stages)]
    delivered = np.zeros(n_stages, np.int64)
    undelivered = np.zeros(n_stages, np.int64)
    for g in range(g_n):
        dmin = delivered_watermark(batches[g], int(n_members[g]))
        end_t = np.cumsum(fold_cost_np(app_pub[g], costs[g]))
        s_g = int(n_senders[g])
        for s in range(s_g):
            arr_rounds, stage_idx = released[g][s]
            if arr_rounds.size == 0:
                continue
            pub_r, pub_idx = sender_app_timeline(app_pub[g, :, s],
                                                 nulls[g, :, s])
            k = pub_r.shape[0]            # published apps (<= released)
            seqs = pub_idx * s_g + s
            dr = np.searchsorted(dmin, seqs)       # delivery rounds
            ok = dr < t_n
            # messages released but never published (capped drain) or
            # published but not yet stable both count undelivered
            n_undel = (arr_rounds.size - k) + int((~ok).sum())
            arr_k = arr_rounds[:k]
            stg_k = stage_idx[:k]
            lr = dr[ok] - arr_k[ok] + 1            # same-round delivery=1
            arr_t = np.where(arr_k[ok] > 0, end_t[arr_k[ok] - 1], 0.0)
            lus = end_t[dr[ok]] - arr_t
            for si in range(n_stages):
                m = stg_k[ok] == si
                if m.any():
                    lat_rounds[si].append(lr[m])
                    lat_us[si].append(lus[m])
                delivered[si] += int(m.sum())
            # attribute undelivered to the stages of the stranded tail
            if n_undel:
                tail_stages = np.concatenate(
                    [stg_k[~ok], stage_idx[k:]])
                for si in range(n_stages):
                    undelivered[si] += int((tail_stages == si).sum())
    stages = []
    for si, tl in enumerate(tallies):
        lr = (np.concatenate(lat_rounds[si]) if lat_rounds[si]
              else np.zeros(0))
        lus = (np.concatenate(lat_us[si]) if lat_us[si]
               else np.zeros(0))
        stages.append(StageStats(
            name=tl.name, rounds=tl.rounds, scale=tl.scale,
            offered=tl.offered, released=tl.released, shed=tl.shed,
            delivered=int(delivered[si]),
            undelivered=int(undelivered[si]),
            p50_rounds=_pct(lr, 50), p99_rounds=_pct(lr, 99),
            p999_rounds=_pct(lr, 99.9),
            mean_rounds=float(lr.mean()) if lr.size else 0.0,
            p50_us=_pct(lus, 50), p99_us=_pct(lus, 99),
            p999_us=_pct(lus, 99.9),
            offered_per_round=tl.offered / tl.rounds,
            goodput_per_round=float(delivered[si]) / tl.rounds,
            max_queue_depth=tl.max_queue_depth,
            max_stream_backlog=tl.max_stream_backlog,
            end_queue_depth=tl.end_queue_depth))
    totals = {
        "offered": int(sum(s.offered for s in stages)),
        "released": int(sum(s.released for s in stages)),
        "shed": int(sum(s.shed for s in stages)),
        "delivered": int(sum(s.delivered for s in stages)),
        "undelivered": int(sum(s.undelivered for s in stages)),
        "rounds": int(sum(s.rounds for s in stages)),
    }
    return LoadReport(stages=stages, totals=totals, run_report=run_report)
