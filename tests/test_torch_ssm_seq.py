"""The preset ``ssm_seq`` on real ``torch.distributed`` ranks for every
family, on the CPU: Mamba's own form of sequence parallelism.

Each rank holds S / tp rows of the (B, S, d) stream, tp the size of
``"model"``, and the mixers whose weights are whole do not gather it:
the Mamba block runs on the rank's rows, its conv reading the previous
rank's last ``d_conv - 1`` inputs and its chunked scan handing the (B,
H, P, N) state from rank to rank (``ssm.ssd_rows``); the SwiGLU, the
MoE's shared experts and the norm sites run on the rows, every whole
leaf entering through ``ranks.copy_to``; the attention reads the
gathered sequence and keeps its rows.  Only the vocabulary and the
experts split over ``"model"``, ``fsdp_embed`` over ``"data"``.  Two and
four ``gloo`` processes (``repro_torch.core.ranks.spawn``) against the
reference's GSPMD steps on four virtual devices (one subprocess a case,
started before the spawns) and the port's own one-rank engine; float32,
drawn from seeds, at 2e-5, 2 steps.  The cases
(``tests/layout_families.py``):

* ``ssm_ss22``: the ssm on ``{"data": 2, "model": 2}``, 32 tokens a
  row: two chunks a rank.
* ``hyb_ss14``: the hybrid on ``{"data": 1, "model": 4}``, 32 tokens:
  one chunk a rank, a fold over four ranks; its shared attention over
  the gathered sequence.
* ``dense_ss2``: the dense test config on ``{"model": 2}``.
* ``moe_ss22``: the MoE on ``{"data": 2, "model": 2}``: its experts on
  ``"model"`` over the gathered tokens, its shared experts on the rows.
* ``vlm_ss2``: the vlm on ``{"model": 2}``.
* ``enc_ss14``: the encdec on ``{"data": 1, "model": 4}``, 17 tokens
  (its vocabulary of 258 stays whole: only the sequence splits).

Held: each rank's blocks laid out as ``spec_to_pspec`` says, the loss,
every first-step gradient block, the parameters and AdamW master after 2
steps, ranks sharing a block holding the same bits, the dry-run's
collectives equal to the ranks' (train with and without remat, prefill,
decode); on one data rank the prefill and greedy decode against the
reference's and a ``ServeEngine`` against the unsplit engine.  On
``meta`` over ``ranks.RankMesh.ledger``: a Mamba layer runs only the
halo and state gathers in its forward, an MLP none, and under
``remat="full"`` every region's boundary tensors are a rank's rows.  In
one process: the rank loop against the whole sequence's scan, and the
gradient through ``ssd_scan``'s state output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import layout_families as L
from repro_torch import tree as tree_util
from repro_torch.core import ranks
from repro_torch.kernels import autograd as kernel_autograd
from repro_torch.models import layers, registry, ssm
from repro_torch.models.config import ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import rules, steps
from test_torch_seq_parallel import CONFIGS, SEEDS, _region_inputs

pytestmark = pytest.mark.fast

CASES = L.SSM_SEQ
SERVED = tuple(c for c in CASES if L.served(c))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background, one process a case, stopped at the module's end."""
    d = tmp_path_factory.mktemp("ssm_seq")
    arrays = L.inputs(CASES, SEEDS)
    np.savez(d / "inputs.npz", **arrays)
    procs = L.start_reference(d, CASES)
    yield {"dir": d, "procs": procs, "arrays": arrays}
    L.stop(procs)


@pytest.fixture(scope="module")
def reference(inputs):
    return L.collect(inputs["dir"], inputs["procs"])


@pytest.fixture(scope="module")
def results(inputs):
    out = L.spawn_cases(CASES, 4, inputs["dir"])
    out.update(L.spawn_cases(CASES, 2, inputs["dir"]))
    return out


@pytest.fixture(scope="module")
def unsplit(inputs):
    return L.unsplit(CASES, inputs["arrays"], inputs["dir"])


@pytest.mark.parametrize("case", CASES)
def test_blocks_are_laid_out_as_spec_to_pspec_says(results, case):
    L.check_blocks(case, results[case])


@pytest.mark.parametrize("case", CASES)
def test_first_gradient_blocks_match_the_reference(results, reference,
                                                   case):
    L.check_grads(case, results[case], reference)


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_the_reference(results, reference, case):
    L.check_steps(case, results[case], reference)


@pytest.mark.parametrize("case", CASES)
def test_ranks_holding_the_same_blocks_hold_the_same_bits(results, case):
    L.check_same_bits(results[case])


@pytest.mark.parametrize("case", CASES)
def test_dry_run_counts_the_collectives_the_ranks_run(results, case):
    L.check_counts(case, results[case])


@pytest.mark.parametrize("case", SERVED)
def test_prefill_and_decode_match_the_reference(results, reference, case):
    L.check_serving(case, results[case], reference)


@pytest.mark.parametrize("case", SERVED)
def test_serve_engine_on_the_ranks_serves_the_unsplit_tokens(
        results, unsplit, case):
    L.check_engine(case, results[case], unsplit)


# ---------------------------------------------------------------------------
# one rank's step on meta over a ledger mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_remat_regions_keep_a_ranks_rows(case, monkeypatch):
    """Under ``remat="full"`` every region's boundary tensors, the
    residual x and the last block's output y, are this rank's S / tp
    rows of the stream: (B, S / tp, d), for each stream of the family
    (the encdec's frames and decoder positions)."""
    seen, shapes = _region_inputs(case, monkeypatch)
    cfg = L.cfg_of(case)
    tp = L.mesh_shape(case)["model"]
    lengths = {shapes["tokens"][1] + shapes.get("patches", (0, 0))[1]}
    if cfg.family == "encdec":
        lengths = {shapes["frames"][1], shapes["tokens"][1] - 1}
    want = {(2, s // tp, cfg.d_model) for s in lengths}
    assert seen and all(s % tp == 0 for s in lengths)
    got = {shape for args in seen for shape in args if shape is not None}
    assert got == want
    assert all(len(args) == 2 for args in seen)


def _forward_collectives(case, fn, s=L.SSM_SEQ_LEN):
    """The collectives of ``fn(p, h, rt)`` on one layer's parameters of
    the case's config, rank 0 of its mesh on ``meta``, over its rows of
    a stream of ``s`` positions, two rows: ``{(kind, operand bytes,
    group): count}``."""
    cfg = L.cfg_of(case)
    mesh = ranks.RankMesh.ledger(L.mesh_shape(case))
    rt = Runtime(mesh=mesh, rules=L.table(case)).on_sequence(s, cfg)
    seq = rt.seq_axis()
    assert seq is not None and rt.seq_rows
    params = tree_util.map(lambda t: t.float(), layers.abstract_tree(
        registry.param_specs(cfg)))
    h = torch.empty((2, s // seq.size, cfg.d_model), device="meta")
    with ranks.ledger() as counts:
        fn(params, h, rt)
    return cfg, seq.size, dict(counts)


def test_a_mamba_layer_runs_only_its_halo_and_state_gathers():
    """A Mamba layer's forward on a rank's rows under ``ssm_seq``: one
    gather of the ranks' conv tails (B, d_conv - 1, conv channels) and
    one of their (B, H, P N + 1) scan pairs, both in float32 here, the
    same at twice the sequence: no collective of the (B, S, d) stream
    or of anything that grows with S."""
    def mamba(params, h, rt):
        p = tree_util.map(lambda t: t[0], params["layers"]["ssm"])
        ssm.mamba_block(p, cfg_, h, rt)

    cfg_ = L.cfg_of("ssm_ss22")
    cfg, tp, got = _forward_collectives("ssm_ss22", mamba)
    d_inner, nh, hp, dn, ng = ssm._dims(cfg)
    tail = 2 * (cfg.ssm.conv_width - 1) * (d_inner + 2 * ng * dn) * 4
    pair = 2 * nh * (hp * dn + 1) * 4
    assert got == {("all-gather", tail, tp): 1,
                   ("all-gather", pair, tp): 1}
    assert _forward_collectives("ssm_ss22", mamba,
                                2 * L.SSM_SEQ_LEN)[2] == got


@pytest.mark.parametrize("case", ["dense_ss2", "hyb_ss14"])
def test_an_mlp_on_a_ranks_rows_runs_no_collective(case):
    """The SwiGLU under ``ssm_seq`` runs on the rank's rows with its
    whole weights: its forward runs no collective (its backward sums
    the weights' gradients, ``layers.on_rows``)."""
    def mlp(params, h, rt):
        m = params["shared_block"]["mlp"] if "shared_block" in params \
            else tree_util.map(lambda t: t[0], params["layers"]["mlp"])
        layers.swiglu(h, m["w_gate"], m["w_up"], m["w_down"], None,
                      rt.seq_axis(), rt.seq_rows)

    assert _forward_collectives(case, mlp)[2] == {}


# ---------------------------------------------------------------------------
# the state handoff in one process
# ---------------------------------------------------------------------------

def _scan_inputs(s, dtype=np.float32):
    rng = np.random.default_rng(s)
    bsz, h, p, g, n = 2, 4, 8, 2, 8
    arrays = {"x": rng.normal(size=(bsz, s, h, p)),
              "dt": rng.normal(size=(bsz, s, h)),
              "a_log": rng.normal(0, 0.5, size=h),
              "b": rng.normal(size=(bsz, s, g, n)),
              "c": rng.normal(size=(bsz, s, g, n)),
              "d_skip": rng.normal(1, 0.3, size=h),
              "dt_bias": rng.normal(0, 0.5, size=h)}
    return {k: v.astype(dtype) for k, v in arrays.items()}


ORDER = ("x", "dt", "a_log", "b", "c", "d_skip", "dt_bias")


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_the_rank_loop_is_the_whole_sequences_scan(tp):
    """Steps (b)-(e) with the ranks simulated in one process: each rank's
    rows convolved after its halo (the previous rank's last d_conv - 1
    inputs, zeros on rank 0), scanned from a zero state
    (``ssm.ssd_local``), every pair stacked in rank order and each
    rank's ``ssm.ssd_handoff``: the rows joined are the whole
    sequence's conv and scan (``ssm.ssd_chunked``), and the reference's
    ``ssd_chunked``, at 1e-5; the final state too."""
    import jax.numpy as jnp
    from repro.models import ssm as ref_ssm

    chunk, width = 4, 4
    s = tp * 2 * chunk
    arr = _scan_inputs(s)
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    rng = np.random.default_rng(7)
    xbc = torch.from_numpy(rng.normal(size=(2, s, 12)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(width, 12)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=12).astype(np.float32))
    sr = s // tp
    rows = [slice(r * sr, (r + 1) * sr) for r in range(tp)]
    convs = []
    for r, at in enumerate(rows):
        halo = xbc[:, at.start - (width - 1):at.start] if r else \
            torch.zeros((2, width - 1, 12))
        convs.append(ssm._conv_window(torch.cat([halo, xbc[:, at]], 1), w,
                                      bias, sr))
    torch.testing.assert_close(torch.cat(convs, 1),
                               ssm._causal_conv(xbc, w, bias), rtol=0, atol=0)

    def part(at):
        return [t[k][:, at] if t[k].dim() > 1 else t[k] for k in ORDER]

    local = [ssm.ssd_local(ssm.ssd_chunked, *part(at), chunk)
             for at in rows]
    every = torch.stack([pair for _, _, pair in local])
    outs = [ssm.ssd_handoff(y0, cs, t["c"][:, at], every, r)
            for r, ((y0, cs, _), at) in enumerate(zip(local, rows))]
    y = torch.cat([out[0] for out in outs], 1)
    want, final = ssm.ssd_chunked(*[t[k] for k in ORDER], chunk)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    for _, state in outs:
        torch.testing.assert_close(state, final, rtol=1e-5, atol=1e-5)
    ref_y, ref_state = ref_ssm.ssd_chunked(
        *[jnp.asarray(arr[k]) for k in ORDER], chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0][1].numpy(), np.asarray(ref_state),
                               rtol=1e-5, atol=1e-5)


def test_the_gradient_through_the_scans_state_is_plain_autograds():
    """``kernel_with_plain_grad`` with the plain scan as the "kernel": a
    loss that reads both outputs, the state as the handoff reads it,
    takes the gradient of plain autograd, exactly."""
    arr = _scan_inputs(16, np.float64)
    rng = np.random.default_rng(3)
    wy = torch.from_numpy(rng.normal(size=arr["x"].shape))
    ws = torch.from_numpy(rng.normal(size=(2, 4, 8, 8)))

    def grads(run):
        t = [torch.from_numpy(arr[k]).requires_grad_() for k in ORDER]
        y, state = run(*t)
        loss = (y * wy).sum() + (state * ws).sum()
        return torch.autograd.grad(loss, t)

    def plain(*t):
        return ssm.ssd_chunked(*t, 4)

    got = grads(lambda *t: kernel_autograd.kernel_with_plain_grad(
        plain, plain, *t))
    for a, b in zip(got, grads(plain)):
        assert torch.equal(a, b)
    assert any(bool(g.abs().sum() > 0) for g in got)


# ---------------------------------------------------------------------------
# the decision and the layouts
# ---------------------------------------------------------------------------

def test_the_rows_form_splits_only_whole_chunks_with_their_halo():
    """``layers.seq_form`` under ``ssm_seq``: ``"rows"`` where the
    sequence divides over ``"model"`` and, for a config with Mamba
    blocks, each rank's rows are whole chunks of at least ``d_conv - 1``
    rows; None (the base path) elsewhere and for a decode step; the
    Megatron form under ``seq_model``."""
    dense, mamba = L.cfg_of("dense_ss2"), L.cfg_of("ssm_ss22")

    def form(shape, preset, s, cfg):
        rt = Runtime(mesh=ranks.RankMesh.ledger(shape),
                     rules=rules.get(preset, cfg))
        on = rt.on_sequence(s, cfg)
        assert (on.seq_axis() is not None) == (
            layers.seq_form(rt, s, cfg) is not None)
        assert on.seq_rows == (layers.seq_form(rt, s, cfg) == "rows")
        return layers.seq_form(rt, s, cfg)

    assert form({"model": 2}, "ssm_seq", 16, dense) == "rows"
    assert form({"model": 2}, "ssm_seq", 6, dense) == "rows"
    assert form({"model": 2}, "ssm_seq", 15, dense) is None
    assert form({"model": 2}, "ssm_seq", 1, dense) is None
    assert form({"data": 2, "model": 2}, "ssm_seq", 32, mamba) == "rows"
    assert form({"data": 2, "model": 2}, "ssm_seq", 16, mamba) == "rows"
    # 4 rows a rank: half a chunk of 8
    assert form({"data": 1, "model": 4}, "ssm_seq", 16, mamba) is None
    assert form({"data": 2, "model": 2}, "ssm_seq", 24, mamba) is None
    assert form({"data": 2, "model": 1}, "ssm_seq", 32, mamba) is None
    assert form({"data": 2, "model": 2}, "seq_model", 32, mamba) == \
        "mixers"
    # the chunk holds the halo or the rows do not split
    short = dataclasses.replace(mamba, ssm=dataclasses.replace(mamba.ssm,
                                                               chunk=2))
    assert form({"data": 1, "model": 4}, "ssm_seq", 16, short) == "rows"
    assert form({"data": 1, "model": 4}, "ssm_seq", 8, short) is None


def test_every_config_lays_out_whole_but_vocabulary_and_experts():
    """All ten configs under ``ssm_seq`` on ``{"data": 2, "model": 2}``
    and ``{"model": 2}``: every leaf as ``spec_to_pspec`` says, only the
    vocabulary and the experts on ``"model"``; ``registry.tp_ways`` is
    1, so that a rank's decode state is the whole one."""
    for name in CONFIGS:
        cfg = registry.get(name).cfg
        table = rules.get("ssm_seq", cfg)
        for shape in ({"data": 2, "model": 2}, {"model": 2}):
            mesh = L.stand_in(shape)
            got = registry.rules_layout(cfg, table, mesh)
            assert got == layers.tree_layout(registry.param_specs(cfg),
                                             table, mesh)
            specs = dict(layers.spec_paths(registry.param_specs(cfg)))
            for path, part in got.items():
                on_model = [n for n, e in zip(specs[path].axes, part)
                            if layers.TP_AXIS in layers.entry_axes(e)]
                assert set(on_model) <= {"vocab", "experts"}, path
            rt = Runtime(mesh=ranks.RankMesh.ledger(shape), rules=table)
            assert registry.tp_ways(cfg, rt) == 1
            cell = ShapeConfig("x", 64, 2, "decode")
            assert registry.cache_specs(
                cfg, cell, tp=registry.tp_ways(cfg, rt)) == \
                registry.cache_specs(cfg, cell)


def test_a_table_with_some_mixers_on_the_sequence_axis_is_refused():
    """``"seq"`` on ``"model"`` with the heads there and the MLP whole:
    neither form, refused naming the axes."""
    cfg = L.cfg_of("dense_ss2")
    table = dict(rules.get("seq_model", cfg), mlp=None)
    with pytest.raises(ValueError, match="mlp"):
        registry.rules_layout(cfg, table, L.stand_in({"model": 2}))
    rt = Runtime(mesh=ranks.RankMesh.ledger({"model": 2}), rules=table)
    assert layers.seq_form(rt, 16, cfg) is None
