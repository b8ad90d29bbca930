"""Batched serving engine with continuous batching and round-robin
delivery (the paper's protocol shape, applied to inference).

Requests are messages; the decode loop is the predicate sweep — every
round it *opportunistically batches* whatever is ready (admits new
requests into free KV-cache slots = SMC ring slots, decodes every active
slot in one step); a slot is freed only after its response is delivered
(slot-reuse rule).  A request that stalls (client backpressure) keeps its
slot but decodes a null step — the batch round never waits.  The
multicast side — each round's admissions and emitted tokens published on
a DDS topic per replica — lives in :mod:`repro_torch.serve.fanout`.

Every decode step is validity-masked: a slot that is idle, stalled, or a
bystander to another slot's prefill keeps its cache rows bit-unchanged.
The decoder writes the valid rows of the cache in place
(:mod:`repro_torch.models.masking`), so no step copies the cache.
Greedy decoding takes ``torch.argmax`` on the device and copies the
``(B,)`` token ids to the host once per step (``host_syncs``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import layers, masking, registry
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.runtime import Runtime


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S_prompt,) int32
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    finished_at: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8                  # KV slots (the ring window w)
    max_len: int = 256
    eos_id: Optional[int] = None


@dataclasses.dataclass
class EngineRound:
    """What one :meth:`ServeEngine.step` did — the per-round event record
    the serve fan-out publishes as multicast messages (one message per
    admission, one per emitted token)."""

    admitted: List[int] = dataclasses.field(default_factory=list)  # slots
    admitted_rids: List[int] = dataclasses.field(default_factory=list)
    emitted: List[int] = dataclasses.field(default_factory=list)   # slots
    finished: List[int] = dataclasses.field(default_factory=list)  # slots
    finished_rids: List[int] = dataclasses.field(default_factory=list)
    stalled: List[int] = dataclasses.field(default_factory=list)   # slots

    def __bool__(self) -> bool:          # truthy = the round made progress
        return bool(self.admitted or self.emitted)


class ServeEngine:
    """Continuous-batching decode engine over a fixed slot ring.

    ``params`` is the architecture's parameter tree on ``device`` (the
    GPU unless ``"cpu"`` is named); the decode cache is allocated there
    in the weights' dtype, a float32 spec in float32
    (:meth:`~repro_torch.models.layers.ParamSpec.dtype_for`).  ``rt``
    picks the kernel sites' implementation
    (:class:`repro_torch.models.runtime.Runtime`).  Under tensor
    parallelism (``rt.rules`` on a rank mesh, ``params`` this rank's
    blocks) every rank of the mesh runs its own engine with the same
    requests: the schedule on the host is the same on every rank, and
    each rank's cache is its part of the decode state
    (``registry.cache_specs`` at ``registry.tp_ways``): the kv heads its
    q heads read, ``(L, B, S_max, Hkv_here, D)``, its ssm heads and conv
    channels, its kv heads of the encdec's cross cache.  The engine
    prefills through decode steps of one position, which never split
    the sequence: under ``seq_model`` and ``megatron_seq`` every prompt
    takes the base preset's path, and the cache keeps its layout."""

    def __init__(self, arch_name: str, params, cfg: ModelConfig,
                 ecfg: EngineConfig, rt: Runtime = Runtime(),
                 device: DeviceLike = None):
        self.arch = registry.get(arch_name)
        self.cfg = cfg
        self.ecfg = ecfg
        self.rt = rt
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device != self.device:
            raise ValueError(f"params are on {embed.device}, the engine "
                             f"on {self.device}")
        self.params = params
        b, s = ecfg.max_batch, ecfg.max_len
        shape = ShapeConfig("engine", s, b, "decode")
        self.cache_specs = registry.cache_specs(
            cfg, shape, batch_override=b, tp=registry.tp_ways(cfg, rt))
        self.cache: Dict[str, Any] = layers.map_specs(
            lambda sp: torch.zeros(sp.shape,
                                   dtype=sp.dtype_for(embed.dtype),
                                   device=self.device), self.cache_specs)
        decode_fn, specs = self.arch.decode_fn(), self.cache_specs

        def _decode_body(p, c, t, pos, valid):
            """One masked decode step: slots where ``valid`` advance
            their state; the rest keep it bit-unchanged."""
            logits, new_c = decode_fn(p, cfg, c, t, pos, rt, valid)
            return logits, masking.masked_update(specs, c, new_c, valid)

        def _reset_body(c, valid):
            """Admission reset: zero the admitted slots' cache rows."""
            return masking.reset_rows(specs, c, valid)

        self.decode = _decode_body
        self._reset_slots = _reset_body
        # slot state (the SMC ring of the serving plane)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_len = np.zeros(b, dtype=np.int64)
        self.queue: deque = deque()
        self.completed: List[Request] = []
        self.rounds = 0
        self.decode_steps = 0
        # device->host syncs taken inside decode rounds (the token-id
        # readback)
        self.host_syncs = 0

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    # -- request plane -------------------------------------------------------

    def submit(self, req: Request):
        req.submitted_at = req.submitted_at or time.time()
        self.queue.append(req)

    def _admit(self, admit_mask: Optional[Sequence[bool]] = None
               ) -> List[int]:
        """Opportunistic admission: fill every free slot that has a ready
        request (never waits to accumulate a batch).  ``admit_mask``
        restricts which slots may admit this round — the serve fan-out
        gates it on the multicast delivery watermark.  Returns the slots
        admitted into."""
        admitted = []
        for slot in range(self.ecfg.max_batch):
            if (self.slot_req[slot] is None and self.queue
                    and (admit_mask is None or admit_mask[slot])):
                req = self.queue.popleft()
                self._prefill_slot(slot, req)
                admitted.append(slot)
        return admitted

    def _prefill_slot(self, slot: int, req: Request):
        """Sequential prefill through the decode path, one prompt token
        per decode step (correctness over speed, as the reference)."""
        self.slot_req[slot] = req
        self.slot_len[slot] = 0
        b = self.ecfg.max_batch
        valid = np.zeros(b, bool)
        valid[slot] = True                # bystander slots: masked no-op
        self.cache = self._reset_slots(self.cache, valid)
        for tok in req.prompt:
            tokens = np.zeros((b, 1), dtype=np.int32)
            tokens[slot, 0] = int(tok)
            pos = self._to_device(self.slot_len.astype(np.int32))
            _, self.cache = self.decode(self.params, self.cache,
                                        self._to_device(tokens), pos, valid)
            self.slot_len[slot] += 1
            self.decode_steps += 1

    # -- the decode sweep ------------------------------------------------------

    def step(self, *, stalled: Optional[Sequence[int]] = None,
             admit_mask: Optional[Sequence[bool]] = None) -> EngineRound:
        """One engine round: admit ready work, decode every active slot.

        ``stalled`` names slots whose client cannot accept output this
        round (backpressure): they keep their slot but make no progress.
        ``admit_mask`` restricts admission (see :meth:`_admit`).  Returns
        the round's :class:`EngineRound` event record."""
        self.rounds += 1
        stalled_set = set(stalled or ())
        info = EngineRound(admitted=self._admit(admit_mask))
        info.admitted_rids = [self.slot_req[s].rid for s in info.admitted]
        info.stalled = sorted(stalled_set & {
            i for i, r in enumerate(self.slot_req) if r is not None})
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in stalled_set]
        if not active:
            return info
        b = self.ecfg.max_batch
        tokens = np.zeros((b, 1), dtype=np.int32)
        for i in active:
            req = self.slot_req[i]
            last = req.tokens_out[-1] if req.tokens_out else \
                int(req.prompt[-1])
            tokens[i, 0] = last
        # one decode for the whole ring with per-slot positions;
        # idle/stalled slots are masked no-ops
        valid = np.zeros(b, bool)
        valid[active] = True
        pos = self._to_device(self.slot_len.astype(np.int32))
        logits, self.cache = self.decode(self.params, self.cache,
                                         self._to_device(tokens), pos, valid)
        self.decode_steps += 1
        self.host_syncs += 1             # token ids cross device->host
        # greedy: the first maximal index per row, as np.argmax
        next_ids = torch.argmax(logits.float(), dim=-1).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            nxt = int(next_ids[i])
            req.tokens_out.append(nxt)
            info.emitted.append(i)
            self.slot_len[i] += 1
            done = (len(req.tokens_out) >= req.max_new_tokens
                    or (self.ecfg.eos_id is not None
                        and nxt == self.ecfg.eos_id)
                    or self.slot_len[i] >= self.ecfg.max_len - 1)
            if done:
                req.finished_at = time.time()
                self.completed.append(req)
                self.slot_req[i] = None    # slot delivered -> reusable
                self.slot_len[i] = 0
                info.finished.append(i)
                info.finished_rids.append(req.rid)
        return info

    def evict(self, slot: int) -> Optional[Request]:
        """Forcibly clear a slot and void its in-flight decode: the
        request's decoded tokens are discarded and the request object is
        returned for re-admission or shed.  Returns ``None`` if the slot
        was idle."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        if req is not None:
            req.tokens_out = []
        return req

    def drained(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    def run_until_drained(self, max_rounds: int = 10_000):
        while not self.drained() and self.rounds < max_rounds:
            self.step()
        return self.completed

    def reset(self) -> None:
        """Clear all request/slot state, keeping params and the cache
        (stale KV entries are position-overwritten before any read)."""
        self.slot_req = [None] * self.ecfg.max_batch
        self.slot_len[:] = 0
        self.queue.clear()
        self.completed = []
        self.rounds = 0
        self.decode_steps = 0
        self.host_syncs = 0
