"""The sharding rules' parameter layouts on real ``torch.distributed``
ranks for the ssm (Mamba2) and hybrid (Zamba2) families, on the CPU.

Two and four ``gloo`` processes (``repro_torch.core.ranks.spawn``), each
rank holding its blocks of the parameters (``layers.shard_params``):
the Mamba block on its heads (its column blocks of the fused projection
and of the conv gathered whole, the gated norm's sum of squares summed
over ``"model"``, ``w_out`` row-parallel), the hybrid's shared block on
its heads and MLP columns.  Against the reference's GSPMD steps on four
virtual devices (one subprocess a case, started before the spawns:
``XLA_FLAGS`` must give them the devices before JAX starts) and the
port's own one-rank runs.  Everything is float32, drawn from seeds, at
2e-5; 2 steps.  The cases (``tests/layout_families.py``):

* ``ssm_bl22``: ``baseline`` on ``{"data": 2, "model": 2}``; the block
  edge of the 296-column projection falls inside x.
* ``ssm_mg2``: ``megatron`` on ``{"model": 2}`` with ``n_groups`` 2,
  each rank's 4 heads one group's.
* ``hyb_bl22``, ``hyb_mg2``, and ``hyb_mg14`` (``megatron`` on ``{"data":
  1, "model": 4}``, whose 2 kv heads stay whole on 4 ranks).

Held: each rank's blocks laid out as ``spec_to_pspec`` says, the loss,
every first-step gradient block, the parameters and AdamW master after
2 steps, ranks sharing a block holding the same bits, the dry-run's
collectives equal to the ranks' (train with and without remat, prefill,
decode); under ``megatron`` greedy decode against the reference's and a
``ServeEngine`` against the unsplit engine, each rank's decode state its
heads' and channels'; under ``baseline`` a ``Trainer`` against the
unsplit one, rank 0's checkpoint whole and a restart bit-identical.
"""

import numpy as np
import pytest

import layout_families as L

pytestmark = pytest.mark.fast

CASES = L.RECURRENT
SERVED = tuple(c for c in CASES if L.served(c))
TRAINED = tuple(c for c in CASES if L.trained(c))
AS_UNSPLIT = tuple(c for c in TRAINED if L.as_unsplit(c))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background, one process a case, stopped at the module's end."""
    d = tmp_path_factory.mktemp("family_layouts_recurrent")
    arrays = L.inputs(CASES)
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


@pytest.mark.parametrize("case", AS_UNSPLIT)
def test_trainer_over_a_laid_out_mesh_matches_the_unsplit_trainer(
        results, unsplit, case):
    L.check_trainer_history(case, results[case], unsplit)


@pytest.mark.parametrize("case", TRAINED)
def test_trainer_rank_zero_writes_the_whole_tree(results, unsplit, case):
    L.check_trainer_checkpoint(case, results[case], unsplit)


@pytest.mark.parametrize("case", TRAINED)
def test_trainer_restart_on_a_laid_out_mesh_is_bit_identical(results,
                                                             case):
    L.check_restart(results[case])


def test_mamba_layouts_that_cannot_split_by_heads_are_refused():
    """A rank's heads must take whole groups (or lie inside one): 6 heads
    in 3 groups split 2 ways would read parts of groups; and the block's
    leaves split over ``"model"`` together or not at all."""
    import dataclasses
    from repro_torch.models import registry, ssm
    from repro_torch.train import rules
    cfg = L.build("ssm")
    assert ssm.rank_dims(cfg, 2) == (4, 1)
    g2 = L.build("ssm-g2")
    assert ssm.rank_dims(g2, 2) == (4, 1) and ssm.rank_dims(g2, 4) == (2, 1)
    g4 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                          n_groups=4))
    assert ssm.rank_dims(g4, 2) == (4, 2) and ssm.rank_dims(g4, 8) == (1, 1)
    odd = dataclasses.replace(cfg, d_model=48, ssm=dataclasses.replace(
        cfg.ssm, n_groups=3))                       # 6 heads in 3 groups
    with pytest.raises(ValueError, match="group edges"):
        ssm.rank_dims(odd, 2)
    with pytest.raises(ValueError, match="group edges"):
        registry.rules_layout(odd, rules.get("megatron", odd),
                              L.stand_in({"model": 2}))
    # the columns split over "model" and the heads kept whole
    table = dict(rules.get("megatron", cfg), ssm_heads=None)
    with pytest.raises(ValueError, match="together or not at all"):
        registry.rules_layout(cfg, table, L.stand_in({"model": 2}))
