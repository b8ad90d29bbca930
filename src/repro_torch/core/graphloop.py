"""Device-resident round loops: one round captured as a CUDA graph whose
control flow is decided on the device.

The reference runs a fused serve epoch or a load profile as one XLA
program: ``lax.while_loop`` over a round body that holds ``lax.cond``
branches and ``fori_loop``\\ s, the whole carry on the device.  The port
keeps the carry in static device buffers and captures ONE round of the
loop as a CUDA graph (:class:`RoundProgram`):

* ``lax.while_loop(cond, body)`` becomes the round graph, its whole body
  under an IF node on the device flag ``state["running"]``; the body ends
  by writing the loop condition of the state it leaves back into that
  flag.  The host replays the graph in chunks of K rounds and reads the
  flag once per chunk (a non-blocking copy to pinned memory behind an
  event), with the next chunk already enqueued, so the card never waits
  on the host and a round reads nothing back.  Replays after the loop
  ended are skipped by the IF node: overshoot changes nothing.
* ``lax.cond`` and each step of an unrolled ``fori_loop`` become nested
  IF nodes through :func:`cond`.

:func:`cond` is the one helper: under a capture it emits an IF node
(``kernels/csrc/graph_cond.cu``: a one-thread kernel sets the node's
condition from the predicate's byte when the graph runs), otherwise it
runs ``if bool(pred): fn()``.  On the CPU the same round body therefore
runs eagerly, branch for branch.

Before its capture a program runs one eager round on throwaway copies of
its state with every branch taken, so every kernel library is built and
loaded and the cuBLAS handle exists.  A host synchronisation inside the
capture (``.item()``, ``.cpu()``, a numpy mask) raises; nothing here
catches it.  Allocations of the round, on the capture stream and in the
IF bodies' own streams, come from private memory pools the program
holds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.kernels import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "graph_if_begin": ([_PTR, _PTR, _PTR], _INT),
    "graph_if_end": ([_PTR, ctypes.POINTER(ctypes.c_size_t)], _INT),
    "graph_body_stream": ([ctypes.POINTER(_PTR)], _INT),
}

# Rounds a chunk replays between two reads of the loop flag.
CHUNK = 32

# Process-wide counters (chip_smoke.py checks them): host reads of a
# loop flag, and graph captures.
STATS = {"flag_reads": 0, "captures": 0}

_LOCAL = threading.local()


def _lib() -> ctypes.CDLL:
    return _build.load("graph_cond", _SIGNATURES)


def build() -> None:
    """Compile and load the IF-node helper now."""
    _lib()


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: cudaError {code}")


class _Capture:
    """What :func:`cond` needs while a round is being captured: the
    graph's memory pool and one body stream per nesting depth."""

    def __init__(self, device: torch.device, warmup: bool):
        self.device = device
        self.warmup = warmup
        self.depth = 0
        self.nodes = 0

    def body_stream(self) -> torch.cuda.ExternalStream:
        streams = getattr(_LOCAL, "streams", None)
        if streams is None:
            streams = _LOCAL.streams = {}
        key = (self.device.index, self.depth)
        if key not in streams:
            ptr = _PTR()
            _check(_build.call_on(self.device.index,
                                  _lib().graph_body_stream,
                                  ctypes.byref(ptr)), "graph_body_stream")
            streams[key] = torch.cuda.ExternalStream(ptr.value,
                                                     device=self.device)
        return streams[key]

    def emit_if(self, pred: torch.Tensor, fn: Callable[[], None]) -> None:
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError("cond wants a one-element bool tensor")
        pred = pred.reshape(()).contiguous()
        lib = _lib()
        body = self.body_stream()
        stream = torch.cuda.current_stream(self.device)
        dev = self.device.index
        _check(_build.call_on(dev, lib.graph_if_begin, stream.cuda_stream,
                              pred.data_ptr(), body.cuda_stream),
               "graph_if_begin")
        self.depth += 1
        count = ctypes.c_size_t(0)
        try:
            with torch.cuda.stream(body):
                fn()
        finally:
            self.depth -= 1
            _check(_build.call_on(dev, lib.graph_if_end, body.cuda_stream,
                                  ctypes.byref(count)), "graph_if_end")
        self.nodes += 1 + count.value


def cond(pred: torch.Tensor, fn: Callable[[], None]) -> None:
    """Run ``fn`` where the one-element bool tensor ``pred`` holds.
    ``fn`` takes no argument and returns nothing: it updates buffers in
    place.  Under a :class:`RoundProgram` capture this is an IF node (and
    in its warm-up round ``fn`` always runs); elsewhere it reads ``pred``
    on the host."""
    cap: Optional[_Capture] = getattr(_LOCAL, "capture", None)
    if cap is None:
        if bool(pred):
            fn()
    elif cap.warmup:
        fn()
    else:
        cap.emit_if(pred, fn)


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class RoundProgram:
    """One round of a device loop over static buffers.

    ``state`` maps names to the loop's buffers (tensors, or lists and
    dicts of them, such as decode caches); ``state["running"]`` is the
    one-element bool loop flag.  ``round_fn(state)`` runs one round in
    place and ends by writing the loop condition of the new state into
    ``state["running"]``.  The caller loads each run's operands into the
    buffers (``copy_``), sets the flag, and calls :meth:`run`.

    On a CUDA device the round is captured once, at the first
    :meth:`run`; every later run replays the same graph.  On the CPU it
    runs eagerly."""

    def __init__(self, state: Dict[str, Any],
                 round_fn: Callable[[Dict[str, Any]], None],
                 device: torch.device):
        self.state = state
        self.round_fn = round_fn
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s = 0.0
        self.nodes = 0
        self.pool_bytes = 0
        self._flags: List[torch.Tensor] = []

    def _round(self) -> None:
        cond(self.state["running"], lambda: self.round_fn(self.state))

    def _capture(self) -> None:
        dev = self.device
        t0 = time.perf_counter()
        _lib()
        # warm-up: one eager round on throwaway copies, every branch taken
        _LOCAL.capture = _Capture(dev, warmup=True)
        try:
            self.round_fn(_clone(self.state))
        finally:
            _LOCAL.capture = None
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        cap = _Capture(dev, warmup=False)
        # the IF bodies are captured on streams of their own, which the
        # graph's own pool does not serve: this thread's allocations go to
        # a second private pool that lives as long as the program
        self._body_pool = torch.cuda.MemPool()
        _LOCAL.capture = cap
        try:
            with torch.cuda.graph(graph), \
                    torch.cuda.use_mem_pool(self._body_pool, dev):
                self._round()
        finally:
            _LOCAL.capture = None
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.nodes = cap.nodes
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self.capture_s = time.perf_counter() - t0
        STATS["captures"] += 1

    def run(self, chunk: int = CHUNK) -> int:
        """Run rounds until the flag drops; returns the flag reads taken
        (0 on the CPU, where each round reads the flag on the host).  On
        the card the graph is replayed ``chunk`` times between two reads,
        with the next chunk enqueued while a read waits; the chunk after
        the last is skipped whole by the IF node."""
        flag = self.state["running"]
        if self.device.type != "cuda":
            while bool(flag):
                self.round_fn(self.state)
            return 0
        if self.graph is None:
            self._capture()
        if not self._flags:
            self._flags = [torch.empty((), dtype=torch.bool,
                                       pin_memory=True) for _ in range(2)]
        stream = torch.cuda.current_stream(self.device)
        pending: List[tuple] = []
        reads = 0

        def launch(slot: int) -> None:
            for _ in range(chunk):
                self.graph.replay()
            host = self._flags[slot]
            host.copy_(flag, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
            pending.append((host, ev))

        slot = 0
        launch(slot)
        slot ^= 1
        launch(slot)
        while True:
            host, ev = pending.pop(0)
            ev.synchronize()
            reads += 1
            if not bool(host):
                break
            slot ^= 1
            launch(slot)
        STATS["flag_reads"] += reads
        return reads
