"""The port's fused sweep (:mod:`repro_torch.core.sweep`) against the
reference's (:mod:`repro.core.sweep`), round by round.

Seeded masked/padded and unpadded stacks (the property cases of
tests/test_stacked.py), with epoch-carry backlogs, on both receive
predicates: the ``max`` merge and the SMC-sweep kernel (the reference's
Pallas kernel in interpret mode; the port's twin on the CPU).  Every
trace and every leaf of the final state — padded lanes included — must be
exactly equal and int32.  A run started mid-way from a reference state
(``state_from_numpy``) must equal the reference's continuation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import group as ref_group
from repro.core import sweep as ref_sweep
from repro_torch.core import group as port_group
from repro_torch.core import sweep

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _ref_leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _assert_state_equal(port_state, ref_state, msg=""):
    got = port_state.to_numpy()
    for name, want in _ref_leaves(ref_state).items():
        assert got[name].dtype == np.int32, (name, msg)
        np.testing.assert_array_equal(got[name], want,
                                      err_msg=f"{name} {msg}")


def _assert_traces_equal(port_traces, ref_traces, msg=""):
    for i, (g, w) in enumerate(zip(port_traces, ref_traces)):
        assert g.dtype == torch.int32, (i, msg)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"trace {i} {msg}")


def _receives(kind: str, ring: int):
    """(port receive_fn, reference receive_fn) for one predicate."""
    if kind == "max":
        return None, None
    return port_group._kernel_receive(ring), ref_group._kernel_receive(ring)


def _scenario(rng):
    n = int(rng.integers(1, 6))
    s = int(rng.integers(1, n + 1))
    rounds = int(rng.integers(4, 16))
    window = int(rng.choice([2, 4, 8, 1 << 20]))
    sched = rng.integers(0, 3, size=(rounds, s)).astype(np.int32)
    null_send = bool(rng.integers(0, 2))
    backlog0 = rng.integers(0, 3, size=s).astype(np.int32)
    return n, s, window, sched, null_send, backlog0


@pytest.mark.parametrize("case", range(8))
def test_scan_rounds_masked_padded_matches_reference(case):
    rng = np.random.default_rng(20260730 + case)
    n, s, window, sched, null_send, backlog0 = _scenario(rng)
    n_pad = n + int(rng.integers(0, 3))
    s_pad = min(s + int(rng.integers(0, 3)), n_pad)
    padded = np.zeros((sched.shape[0], s_pad), np.int32)
    padded[:, :s] = sched
    b0 = np.zeros(s_pad, np.int32)
    b0[:s] = backlog0
    member_mask = np.arange(n_pad) < n
    sender_mask = np.arange(s_pad) < s
    ref_state, ref_traces = ref_sweep.scan_rounds(
        ref_sweep.SweepState.init(n_pad, s_pad), jnp.asarray(padded),
        window=window, null_send=null_send,
        member_mask=jnp.asarray(member_mask),
        sender_mask=jnp.asarray(sender_mask), backlog0=jnp.asarray(b0))
    state, traces = sweep.scan_rounds(
        sweep.SweepState.init(n_pad, s_pad, CPU), _t(padded),
        window=window, null_send=null_send,
        member_mask=_t(member_mask, torch.bool),
        sender_mask=_t(sender_mask, torch.bool), backlog0=_t(b0))
    _assert_traces_equal(traces, ref_traces, f"case {case}")
    _assert_state_equal(state, ref_state, f"case {case}")
    # ... and the active sub-array equals the unpadded run
    _, solo = sweep.scan_rounds(
        sweep.SweepState.init(n, s, CPU), _t(sched), window=window,
        null_send=null_send, backlog0=_t(backlog0))
    np.testing.assert_array_equal(traces[0][:, :n].numpy(),
                                  solo[0].numpy())
    np.testing.assert_array_equal(traces[1][:, :s].numpy(),
                                  solo[1].numpy())


@pytest.mark.parametrize("case", range(3))
def test_scan_rounds_kernel_receive_matches_pallas(case):
    rng = np.random.default_rng(777 + case)
    n, s, window, sched, null_send, backlog0 = _scenario(rng)
    window = min(window, 8)
    member_mask = np.arange(n + 1) < n       # one padded member row
    sender_mask = np.ones(s, bool)
    port_recv, ref_recv = _receives("kernel", window)
    ref_state, ref_traces = ref_sweep.scan_rounds(
        ref_sweep.SweepState.init(n + 1, s), jnp.asarray(sched),
        window=window, null_send=null_send, receive_fn=ref_recv,
        member_mask=jnp.asarray(member_mask),
        sender_mask=jnp.asarray(sender_mask),
        backlog0=jnp.asarray(backlog0))
    state, traces = sweep.scan_rounds(
        sweep.SweepState.init(n + 1, s, CPU), _t(sched),
        window=window, null_send=null_send, receive_fn=port_recv,
        member_mask=_t(member_mask, torch.bool),
        sender_mask=_t(sender_mask, torch.bool), backlog0=_t(backlog0))
    _assert_traces_equal(traces, ref_traces, f"case {case}")
    _assert_state_equal(state, ref_state, f"case {case}")


def _hetero_stack(seed, n_sub=3):
    rng = np.random.default_rng(seed)
    members = [int(rng.integers(2, 6)) for _ in range(n_sub)]
    senders = [int(rng.integers(1, m + 1)) for m in members]
    n_max, s_max = max(members), max(senders)
    rounds = 14
    scheds = np.zeros((n_sub, rounds, s_max), np.int32)
    for g in range(n_sub):
        scheds[g, :, : senders[g]] = rng.integers(0, 3,
                                                  size=(rounds, senders[g]))
    windows = rng.choice([2, 4, 8], size=n_sub).astype(np.int32)
    member_masks = np.arange(n_max)[None, :] < np.array(members)[:, None]
    sender_masks = np.arange(s_max)[None, :] < np.array(senders)[:, None]
    backlogs0 = np.where(sender_masks, rng.integers(0, 3, size=sender_masks
                                                    .shape), 0).astype(
                                                        np.int32)
    return (n_max, s_max, scheds, windows, member_masks, sender_masks,
            backlogs0)


@pytest.mark.parametrize("receive", ["max", "kernel"])
@pytest.mark.parametrize("null_send", [True, False])
def test_run_stacked_masked_matches_reference(receive, null_send):
    n_max, s_max, scheds, windows, mm, sm, b0 = _hetero_stack(42)
    g = scheds.shape[0]
    port_recv, ref_recv = _receives(receive, int(windows.max()))
    ref_state, ref_traces = ref_sweep.run_stacked(
        ref_sweep.batch_states(n_max, s_max, g), jnp.asarray(scheds),
        windows=jnp.asarray(windows), null_send=null_send,
        member_masks=jnp.asarray(mm), sender_masks=jnp.asarray(sm),
        receive_fn=ref_recv, backlogs0=jnp.asarray(b0))
    state, traces = sweep.run_stacked(
        sweep.batch_states(n_max, s_max, g, CPU), _t(scheds),
        windows=_t(windows), null_send=null_send,
        member_masks=_t(mm, torch.bool), sender_masks=_t(sm, torch.bool),
        receive_fn=port_recv, backlogs0=_t(b0))
    _assert_traces_equal(traces, ref_traces, receive)
    _assert_state_equal(state, ref_state, receive)


@pytest.mark.parametrize("receive", ["max", "kernel"])
def test_run_stacked_unpadded_matches_reference(receive):
    rng = np.random.default_rng(5)
    g, n, s, rounds = 2, 4, 3, 12
    scheds = rng.integers(0, 3, size=(g, rounds, s)).astype(np.int32)
    windows = np.array([3, 8], np.int32)
    port_recv, ref_recv = _receives(receive, 8)
    ref_state, ref_traces = ref_sweep.run_stacked(
        ref_sweep.batch_states(n, s, g), jnp.asarray(scheds),
        windows=jnp.asarray(windows), null_send=True, receive_fn=ref_recv)
    state, traces = sweep.run_stacked(
        sweep.batch_states(n, s, g, CPU), _t(scheds), windows=_t(windows),
        null_send=True, receive_fn=port_recv)
    _assert_traces_equal(traces, ref_traces, receive)
    _assert_state_equal(state, ref_state, receive)


@pytest.mark.parametrize("receive", ["max", "kernel"])
def test_run_stacked_batch_matches_reference(receive):
    """B grid points x G subgroups: per-point windows and traced
    null-send flags over a shared heterogeneous stack."""
    n_max, s_max, scheds, _, mm, sm, _ = _hetero_stack(7)
    b, g = 3, scheds.shape[0]
    rng = np.random.default_rng(8)
    bscheds = np.stack([np.roll(scheds, i, axis=1) for i in range(b)])
    windows = rng.choice([2, 3, 8], size=(b, g)).astype(np.int32)
    null_sends = np.array([True, False, True])
    port_recv, ref_recv = _receives(receive, int(windows.max()))
    ref_states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (b,) + x.shape),
        ref_sweep.batch_states(n_max, s_max, g))
    ref_state, ref_traces = ref_sweep.run_stacked_batch(
        ref_states, jnp.asarray(bscheds), windows=jnp.asarray(windows),
        null_sends=jnp.asarray(null_sends), member_masks=jnp.asarray(mm),
        sender_masks=jnp.asarray(sm), receive_fn=ref_recv)
    state, traces = sweep.run_stacked_batch(
        sweep.batch_states(n_max, s_max, (b, g), CPU), _t(bscheds),
        windows=_t(windows), null_sends=_t(null_sends, torch.bool),
        member_masks=_t(mm, torch.bool), sender_masks=_t(sm, torch.bool),
        receive_fn=port_recv)
    _assert_traces_equal(traces, ref_traces, receive)
    _assert_state_equal(state, ref_state, receive)


@pytest.mark.parametrize("k", [3, 9])
def test_continuation_from_reference_state(k):
    """Start the port from the reference's state after k rounds (through
    ``state_from_numpy``) and run the rest: the rounds that follow equal
    the reference's continuation and its uninterrupted run."""
    rng = np.random.default_rng(99)
    n, s, rounds, window = 5, 3, 16, 3
    sched = rng.integers(0, 3, size=(rounds, s)).astype(np.int32)
    _, full = ref_sweep.scan_rounds(
        ref_sweep.SweepState.init(n, s), jnp.asarray(sched), window=window)
    mid, _ = ref_sweep.scan_rounds(
        ref_sweep.SweepState.init(n, s), jnp.asarray(sched[:k]),
        window=window)
    backlog = (sched[:k].sum(0) - np.asarray(mid.app_sent)).astype(np.int32)
    ref_end, ref_rest = ref_sweep.scan_rounds(
        mid, jnp.asarray(sched[k:]), window=window,
        backlog0=jnp.asarray(backlog))
    start = sweep.state_from_numpy(_ref_leaves(mid), device=CPU)
    end, rest = sweep.scan_rounds(start, _t(sched[k:]), window=window,
                                  backlog0=_t(backlog))
    _assert_traces_equal(rest, ref_rest, f"k={k}")
    _assert_state_equal(end, ref_end, f"k={k}")
    for got, whole in zip(rest, full):
        np.testing.assert_array_equal(got.numpy(), np.asarray(whole)[k:])
    again = sweep.state_from_numpy(end.to_numpy(), device=CPU)
    _assert_state_equal(again, ref_end, "to_numpy round trip")


def test_run_rounds_matches_reference():
    rng = np.random.default_rng(3)
    sched = rng.integers(0, 2, size=(20, 4)).astype(np.int32)
    ref_state, ref_batches = ref_sweep.run_rounds(
        ref_sweep.SweepState.init(6, 4), jnp.asarray(sched), window=4,
        null_send=False)
    state, batches = sweep.run_rounds(
        sweep.SweepState.init(6, 4, CPU), _t(sched), window=4,
        null_send=False)
    _assert_traces_equal([batches], [ref_batches])
    _assert_state_equal(state, ref_state)


def test_stream_stacked_rounds_equal_run_stacked():
    n_max, s_max, scheds, windows, mm, sm, _ = _hetero_stack(11)
    g, rounds = scheds.shape[0], scheds.shape[1]
    kw = dict(windows=_t(windows), null_send=True,
              member_masks=_t(mm, torch.bool),
              sender_masks=_t(sm, torch.bool))
    _, whole = sweep.run_stacked(sweep.batch_states(n_max, s_max, g, CPU),
                                 _t(scheds), **kw)
    states = sweep.batch_states(n_max, s_max, g, CPU)
    backlogs = torch.zeros((g, s_max), dtype=torch.int32)
    for t in range(rounds):
        (states, backlogs), step = sweep.stream_stacked(
            states, backlogs, _t(scheds[:, t]), **kw)
        for got, trace in zip(step, whole):
            np.testing.assert_array_equal(got.numpy(), trace[:, t].numpy())


@pytest.mark.parametrize("rounds", [2, 6, 30])
def test_quiescent_stacked_matches_reference(rounds):
    n_max, s_max, scheds, windows, mm, sm, _ = _hetero_stack(13)
    g = scheds.shape[0]
    scheds = np.concatenate([scheds, np.zeros((g, 30, s_max), np.int32)],
                            axis=1)[:, :rounds]
    ref_state, _ = ref_sweep.run_stacked(
        ref_sweep.batch_states(n_max, s_max, g), jnp.asarray(scheds),
        windows=jnp.asarray(windows), null_send=True,
        member_masks=jnp.asarray(mm), sender_masks=jnp.asarray(sm))
    state = sweep.state_from_numpy(_ref_leaves(ref_state), device=CPU)
    backlogs = np.zeros((g, s_max), np.int32)
    n_members, n_senders = mm.sum(1), sm.sum(1)
    want = bool(ref_sweep.quiescent_stacked(
        ref_state, jnp.asarray(backlogs), n_members=jnp.asarray(n_members),
        n_senders=jnp.asarray(n_senders)))
    got = sweep.quiescent_stacked(state, _t(backlogs), n_members=n_members,
                                  n_senders=n_senders)
    assert got.dim() == 0 and bool(got) == want
    assert bool(sweep.quiescent_stacked(state, _t(backlogs))) == bool(
        ref_sweep.quiescent_stacked(ref_state, jnp.asarray(backlogs)))


def test_state_init_needs_a_device_or_the_gpu():
    if torch.cuda.is_available():
        assert sweep.SweepState.init(3, 2).published.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep.SweepState.init(3, 2)
    st = sweep.batch_states(3, 2, (2, 4), CPU)
    assert st.recv_vis.shape == (2, 4, 3, 3)
    assert all(v.dtype == np.int32 for v in st.to_numpy().values())
