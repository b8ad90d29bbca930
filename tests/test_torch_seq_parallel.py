"""The sequence-parallel presets ``seq_model`` and ``megatron_seq`` on
real ``torch.distributed`` ranks for every family, on the CPU.

Megatron's sequence parallelism: where ``layers.seq_axis`` splits a
call's sequence (the rules put ``"seq"`` on ``"model"``, that axis has
more than one rank and the sequence divides over it), each rank holds
its S / tp rows of the (B, S, d) stream between the mixers, the norm
sites run on them, and each mixer runs between a gather of the rows and
a reduce-scatter of its output.  The parameters are laid out as under
``baseline`` and ``megatron``.  Two and four ``gloo`` processes
(``repro_torch.core.ranks.spawn``) against the reference's GSPMD steps
on four virtual devices (one subprocess a case, started before the
spawns) and the port's own one-rank engine; float32, drawn from seeds,
at 2e-5, 2 steps.  The cases (``tests/layout_families.py``):

* ``dense_sm22``: the dense test config (qk-norm, tied embeddings)
  under ``seq_model`` on ``{"data": 2, "model": 2}``.
* ``qwen2_ms14``: the qwen2-like config under ``megatron_seq`` on
  ``{"data": 1, "model": 4}`` (its 2 kv heads stay whole on 4 ranks).
* ``moe_sm22``: the MoE under ``seq_model``: its routed experts read the
  gathered tokens.
* ``vlm_ms2``: the vlm under ``megatron_seq`` on ``{"model": 2}``: the
  combined [patches; text] sequence built whole, then split.
* ``enc_ms14``: the encdec under ``megatron_seq`` on ``{"data": 1,
  "model": 4}`` (its vocabulary of 258 stays whole: the embedding's
  lookup split, the head's input gathered whole): both streams split
  (17 tokens a row, so that the decoder's 16 divide), the memory
  gathered once a forward.
* ``ssm_sm22``, ``hyb_ms14``: the Mamba block between a gather and a
  reduce-scatter (the conv causal over the whole sequence).

Held: each rank's blocks laid out as ``spec_to_pspec`` says, the loss,
every first-step gradient block, the parameters and AdamW master after 2
steps, ranks sharing a block holding the same bits, the dry-run's
collectives equal to the ranks' (train with and without remat, prefill,
decode); under ``megatron_seq`` the prefill and greedy decode against
the reference's and a ``ServeEngine`` against the unsplit engine.  On
``meta`` over ``ranks.RankMesh.ledger``: a sequence that does not divide
runs the base preset's collectives exactly, and under ``remat="full"``
every region's two boundary tensors are a rank's S / tp rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import layout_families as L
from repro_torch.core import ranks
from repro_torch.launch import dryrun
from repro_torch.models import layers, registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import rules, steps

pytestmark = pytest.mark.fast

CASES = L.SEQ_PARALLEL
SERVED = tuple(c for c in CASES if L.served(c))
# the cases whose sequence length need not be a multiple of an ssm chunk
UNCHUNKED = tuple(c for c in CASES if L.cfg_of(c).ssm is None)
BASE = {"seq_model": "baseline", "megatron_seq": "megatron"}
# each config's weights: those its base-preset cases are held to in
# tests/test_torch_family_layouts*.py (the hybrid's, drawn from seed 42,
# take the reference's own float32 gradient 1.2e-4 from a float64 run,
# and the base preset's step past 2e-5 as well)
SEEDS = {"dense": 40, "encdec": 40, "hybrid": 40, "moe": 41, "qwen2": 44,
         "ssm": 41, "vlm": 42}
# the repo's ten model configs
CONFIGS = ("deepseek-moe-16b", "internvl2-26b", "mamba2-2.7b",
           "qwen1.5-0.5b", "qwen2-1.5b", "qwen2-72b", "qwen2-moe-a2.7b",
           "qwen3-1.7b", "seamless-m4t-medium", "zamba2-2.7b")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background, one process a case, stopped at the module's end."""
    d = tmp_path_factory.mktemp("seq_parallel")
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

def _collectives(case, preset, shape):
    cfg = L.cfg_of(case)
    mesh = L.mesh_shape(case)
    table = rules.get(preset, cfg)
    batch_axes = dryrun._batch_axes(table, L.stand_in(mesh),
                                    shape.global_batch)
    return sorted(dryrun.layout_collectives(registry.Arch(cfg), shape,
                                            table, mesh, batch_axes,
                                            "none"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("case", UNCHUNKED)
def test_a_sequence_that_does_not_divide_runs_the_base_collectives(case,
                                                                   kind):
    """A train step over 15 positions (the encdec's 7 frames and 6
    decoder positions) and a prefill of 7 split over no rank: their
    collectives are the base preset's, one for one; at 16 and 8 they
    split and gather."""
    preset = L.CASES[case][2]
    odd, even = (15, 16) if kind == "train" else (7, 8)
    got = _collectives(case, preset, ShapeConfig("odd", odd, 4, kind))
    assert got == _collectives(case, BASE[preset],
                               ShapeConfig("odd", odd, 4, kind))
    split = _collectives(case, preset, ShapeConfig("even", even, 4, kind))
    assert split != _collectives(case, BASE[preset],
                                 ShapeConfig("even", even, 4, kind))
    assert any(op == "reduce-scatter" for op, *_ in split)


def _region_inputs(case, monkeypatch):
    """The shapes of every region's inputs ``(y, x)`` in one gradient of
    the case's config on rank 0 of its mesh under ``remat="full"``, on
    ``meta``, over two rows of the case's batch: the tensors the
    checkpointed regions keep.  Returns them and the batch's shapes."""
    seen = []
    wrap = Runtime.checkpoint

    def spy(self, fn):
        run = wrap(self, fn)

        def call(*args):
            if self.remat == "full" and torch.is_grad_enabled():
                seen.append([None if a is None else tuple(a.shape)
                             for a in args])
            return run(*args)
        return call

    monkeypatch.setattr(Runtime, "checkpoint", spy)
    cfg = L.cfg_of(case)
    arch = registry.Arch(cfg)
    mesh = ranks.RankMesh.ledger(L.mesh_shape(case))
    rt = Runtime(mesh=mesh, rules=L.table(case), remat="full")
    specs = arch.param_specs()
    params = layers.shard_params(layers.abstract_tree(specs), specs,
                                 rt.rules_(), mesh)
    batch = {k: torch.empty(v[:2].shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in L.batch(case, 0).items()}
    with ranks.ledger():
        steps.value_and_grad(arch, rt)(params, batch)
    return seen, {k: tuple(v.shape) for k, v in batch.items()}


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


# ---------------------------------------------------------------------------
# the decision and the layouts
# ---------------------------------------------------------------------------

def test_the_sequence_splits_only_on_a_split_model_axis_it_divides():
    """``layers.seq_axis``: the ``"model"`` axis for a sequence that
    divides over it under a preset with ``"seq"`` there; None for a
    decode step, a length that does not divide, ``baseline``, and a
    ``"model"`` axis of one rank."""
    cfg = L.cfg_of("dense_sm22")

    def axis(shape, preset, s):
        rt = Runtime(mesh=ranks.RankMesh.ledger(shape),
                     rules=rules.get(preset, cfg))
        return layers.seq_axis(rt, s), rt.on_sequence(s).seq_axis()

    for preset in ("seq_model", "megatron_seq"):
        got, on = axis({"data": 2, "model": 2}, preset, 16)
        assert got is not None and got.name == layers.TP_AXIS and \
            got.size == 2 and on is got
        assert axis({"data": 1, "model": 4}, preset, 12)[0].size == 4
        for shape, s in (({"data": 2, "model": 2}, 1),
                         ({"data": 2, "model": 2}, 15),
                         ({"data": 1, "model": 4}, 6),
                         ({"data": 4, "model": 1}, 16)):
            assert axis(shape, preset, s) == (None, None), (shape, s)
    assert axis({"data": 2, "model": 2}, "baseline", 16) == (None, None)
    assert Runtime().on_sequence(16).seq_axis() is None
    rt = Runtime(mesh=ranks.RankMesh.ledger({"model": 2}),
                 rules=rules.get("megatron_seq", cfg))
    assert rt.on_sequence(16).on_sequence(3) == rt


def test_every_config_lays_out_under_the_sequence_presets():
    """All ten configs come back laid out under ``seq_model`` and
    ``megatron_seq`` on ``{"data": 2, "model": 2}`` and ``{"model":
    2}``, every leaf as ``spec_to_pspec`` says, and as under the base
    preset (the sequence is no parameter's axis); under ``ssm_seq`` on
    ``{"data": 2, "model": 2}`` too every config lays out, every leaf as
    ``spec_to_pspec`` says, and ``"seq"`` on ``"data"`` raises naming
    the axis."""
    for name in CONFIGS:
        cfg = registry.get(name).cfg
        for shape in ({"data": 2, "model": 2}, {"model": 2}):
            for preset in ("seq_model", "megatron_seq"):
                table = rules.get(preset, cfg)
                got = registry.rules_layout(cfg, table, L.stand_in(shape))
                assert got == layers.tree_layout(registry.param_specs(cfg),
                                                 table, L.stand_in(shape))
                assert got == registry.rules_layout(
                    cfg, rules.get(BASE[preset], cfg), L.stand_in(shape))
        shape = L.stand_in({"data": 2, "model": 2})
        table = rules.get("ssm_seq", cfg)
        assert registry.rules_layout(cfg, table, shape) == \
            layers.tree_layout(registry.param_specs(cfg), table, shape)
        table = dict(rules.get("seq_model", cfg), seq="data")
        with pytest.raises(ValueError, match="'data'"):
            registry.rules_layout(cfg, table, shape)


def test_the_sequence_parallel_collectives_have_their_transposes():
    """``reduce_scatter_to``, ``split_to`` and ``gather_whole`` on a
    ledger mesh's rank 0: the forward's collective and the backward's,
    each counted once with its operand (``split_to`` gathers only in
    its backward, ``gather_whole`` only in its forward)."""
    axis = ranks.RankMesh.ledger({"model": 2}).axis("model")
    x = torch.empty((2, 8, 4), device="meta", requires_grad=True)
    bytes_ = 2 * 8 * 4 * 4
    for fn, forward, backward, out_rows in (
            (ranks.reduce_scatter_to, ("reduce-scatter", bytes_),
             ("all-gather", bytes_ // 2), 4),
            (ranks.split_to, None, ("all-gather", bytes_ // 2), 4),
            (ranks.gather_whole, ("all-gather", bytes_), None, 16)):
        with ranks.ledger() as fwd:
            y = fn(x, axis, 1)
        assert y.shape == (2, out_rows, 4)
        with ranks.ledger() as bwd:
            (g,) = torch.autograd.grad(y.sum(), x)
        assert g.shape == x.shape
        assert fwd == ({} if forward is None else {(*forward, 2): 1})
        assert bwd == ({} if backward is None else {(*backward, 2): 1})


def test_a_runtime_on_a_sequence_compares_by_its_decision():
    cfg = L.cfg_of("dense_sm22")
    mesh = ranks.RankMesh.ledger({"data": 2, "model": 2})
    rt = Runtime(mesh=mesh, rules=rules.get("seq_model", cfg))
    on = rt.on_sequence(16)
    assert on.seq_split and not rt.seq_split and on != rt
    assert dataclasses.replace(on, seq_split=False) == rt
    assert hash(on) == hash(rt.on_sequence(32))
