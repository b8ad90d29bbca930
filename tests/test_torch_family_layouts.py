"""The sharding rules' parameter layouts on real ``torch.distributed``
ranks for the moe, vlm and encdec families, on the CPU.

Two and four ``gloo`` processes (``repro_torch.core.ranks.spawn``), each
rank holding its blocks of the parameters (``layers.shard_params``):
the MoE's attention and shared experts on its heads and columns, its
routed experts split over the same ``"model"`` axis, the router whole;
the vlm's projector gathered over ``"data"``; the encdec's encoder,
decoder and cross attention on its heads, the cross cache its kv
heads'.  Against the reference's GSPMD steps on four
virtual devices (one subprocess a case, started before the spawns:
``XLA_FLAGS`` must give them the devices before JAX starts) and the
port's own one-rank runs.  Everything is float32, drawn from seeds, at
2e-5; 2 steps.  The cases (``tests/layout_families.py``):

* ``moe_bl22`` (``baseline`` on ``{"data": 2, "model": 2}``: the
  reported loss carries data shard 0's aux, as the reference's
  ``shard_map`` hands it back) and ``moe_mg2`` (``megatron`` on
  ``{"model": 2}``).
* ``vlm_bl22``, ``vlm_mg2``.
* ``enc_bl22``, ``enc_mg2``, and ``enc_mg14`` (``megatron`` on ``{"data":
  1, "model": 4}``, whose vocabulary of 258 stays whole on 4 ranks: the
  embedding, the unembedding and the loss take it whole).

Held: each rank's blocks laid out as ``spec_to_pspec`` says, the loss,
every first-step gradient block, the parameters and AdamW master after
2 steps, ranks sharing a block holding the same bits, the dry-run's
collectives equal to the ranks' (train with and without remat, prefill,
decode); under ``megatron`` the prefill (the moe's and vlm's KV cache,
the encdec's encoder memory) and greedy decode against the reference's
and a ``ServeEngine`` against the unsplit engine, each rank's caches its
kv heads'; under ``baseline`` and for the MoE on ``{"model": 2}`` a
``Trainer``: rank 0's checkpoint whole and a restart bit-identical, the
history and the checkpoint against the unsplit Trainer's where the steps
are its function (not the MoE over two data shards: capacity and aux
loss come from each shard's tokens there).
"""

import numpy as np
import pytest

import layout_families as L

pytestmark = pytest.mark.fast

CASES = L.FAMILIES
SERVED = tuple(c for c in CASES if L.served(c))
TRAINED = tuple(c for c in CASES if L.trained(c))
AS_UNSPLIT = tuple(c for c in TRAINED if L.as_unsplit(c))
# the repo's ten model configs
CONFIGS = ("deepseek-moe-16b", "internvl2-26b", "mamba2-2.7b",
           "qwen1.5-0.5b", "qwen2-1.5b", "qwen2-72b", "qwen2-moe-a2.7b",
           "qwen3-1.7b", "seamless-m4t-medium", "zamba2-2.7b")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background, one process a case, stopped at the module's end."""
    d = tmp_path_factory.mktemp("family_layouts")
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


def test_every_config_lays_out_under_baseline_and_megatron():
    """All ten configs come back laid out under ``baseline`` on ``{"data":
    2, "model": 2}`` and ``megatron`` on ``{"model": 2}``, every leaf as
    ``spec_to_pspec`` says; the vocabularies that do not divide the
    ``"model"`` ranks stay whole (internvl2-26b's 92,553 on 2,
    seamless-m4t-medium's 256,206 on 4)."""
    from repro_torch.models import layers, registry
    from repro_torch.train import rules
    for name in CONFIGS:
        cfg = registry.get(name).cfg
        for shape, preset in (({"data": 2, "model": 2}, "baseline"),
                              ({"model": 2}, "megatron")):
            table = rules.get(preset, cfg)
            got = registry.rules_layout(cfg, table, L.stand_in(shape))
            assert got == layers.tree_layout(registry.param_specs(cfg),
                                             table, L.stand_in(shape))
    for name, n, whole in (("internvl2-26b", 2, True),
                           ("seamless-m4t-medium", 2, False),
                           ("seamless-m4t-medium", 4, True)):
        cfg = registry.get(name).cfg
        got = registry.rules_layout(cfg, rules.get("megatron", cfg),
                                    L.stand_in({"model": n}))
        assert (got["embed"][0] is None) == whole, (name, n)
