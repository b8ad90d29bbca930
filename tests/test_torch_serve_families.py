"""The moe, vlm and encdec families on the port's serve plane, in float32
on the CPU, at the reference's ``reduced()`` presets of qwen2-moe-a2.7b,
deepseek-moe-16b, internvl2-26b and seamless-m4t-medium.

* ``ReplicatedEngine.run`` (two replicas of two slots, a stalled client,
  ``test_torch_serve``'s scenario) on the port's ``graph`` backend
  against the reference's: tokens, per-topic delivery logs, counters and
  round traces exactly equal.  The reference's encdec decode takes one
  scalar position for the whole batch, where the engine passes one a
  slot; its step is run row by row here, each row at its own position
  (the port's per-row form).
* A decode step through the engine's masked body leaves the rows it does
  not serve bit-unchanged, in every cache leaf (the encdec's cross cache
  included).
* The MoE: batched serving (mid-ring admissions beside idle and busy
  slots) gives each request its solo tokens — the decode's capacity
  covers every row, so no route drops; and ``run(fused=True)`` equals
  the per-round loop exactly and the reference's fused run in tokens and
  logs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro_torch import api
from repro_torch.models import convert, moe, registry
from test_torch_serve import SCENARIOS, _assert_logs_equal, _run_both
from test_torch_serve_fused import _assert_conformant
from test_torch_serve_recurrent import (_port_engines, _port_rep,
                                        _ref_engines, _ref_rep, _tokens)

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

PRESETS = ("qwen2-moe-a2.7b", "deepseek-moe-16b", "internvl2-26b",
           "seamless-m4t-medium")


def _register(preset):
    """The reduced preset under a test name in both registries."""
    name = f"serve-family-{preset}"
    ref_cfg = dataclasses.replace(ref_registry.get(preset).cfg.reduced(),
                                  name=name)
    cfg = dataclasses.replace(registry.get(preset).cfg.reduced(), name=name)
    ref_registry.register(name, lambda: ref_cfg)
    registry.register(name, lambda: cfg)
    return name, ref_cfg, cfg


@pytest.fixture(scope="module", params=PRESETS)
def family(request):
    """(name, reference config, port config, float32 numpy params)."""
    name, ref_cfg, cfg = _register(request.param)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          ref_layers.init_tree(
                              ref_registry.param_specs(ref_cfg),
                              jax.random.key(0)))
    return name, ref_cfg, cfg, params


def _per_row(decode):
    """The reference's scalar-position decode step run row by row, each
    row at its own position."""

    def step(params, cfg, cache, tokens, position, rt):
        outs = [decode(params, cfg, {k: v[:, r:r + 1]
                                     for k, v in cache.items()},
                       tokens[r:r + 1], position[r], rt)
                for r in range(tokens.shape[0])]
        return (jnp.concatenate([o[0] for o in outs]),
                {k: jnp.concatenate([o[1][k] for o in outs], axis=1)
                 for k in cache})

    return step


def test_replicated_engine_matches_the_reference(monkeypatch, family):
    monkeypatch.setattr(ref_encdec, "decode_step",
                        _per_row(ref_encdec.decode_step))
    reports = _run_both(monkeypatch, _port_engines(family, 2, 2),
                        _ref_engines(family, 2, 2), "graph", "graph",
                        SCENARIOS["stall_fn"])
    serve = reports[0].extras["serve"]
    assert serve["drained"] and serve["stall_rounds"] == 3
    assert serve["tokens"] > 0


def test_unserved_rows_stay_bit_unchanged(family):
    """One masked decode step with rows 0 and 2 of 3 valid, over a cache
    of random values: rows 1 keep every bit, in every leaf."""
    name, _, cfg, params = family
    p = convert.params_from_numpy(params, cfg, "cpu", torch.float32)
    eng = api.ServeEngine(name, p, cfg, api.EngineConfig(max_batch=3,
                                                         max_len=16),
                          device="cpu")
    rng = np.random.default_rng(1)
    eng.cache = convert.cache_from_numpy(
        {k: rng.normal(size=v.shape) for k, v in eng.cache.items()}, cfg,
        3, 16, "cpu", torch.float32)
    before = {k: v.clone() for k, v in eng.cache.items()}
    valid = np.array([True, False, True])
    logits, cache = eng.decode(p, eng.cache, torch.ones((3, 1),
                                                        dtype=torch.int32),
                               torch.tensor([4, 7, 9]), valid)
    assert all(cache[k] is eng.cache[k] for k in cache)
    assert logits.shape == (3, cfg.vocab_size)
    for k, v in cache.items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        if k.startswith("cross"):
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v[:, 0], before[k][:, 0]), k


@pytest.mark.parametrize("preset", ["qwen2-moe-a2.7b"])
def test_moe_serves_batched_as_solo_and_fused(monkeypatch, preset):
    """Two slots, three requests: the same tokens as each request served
    alone (the capacity of the decode's 2 rows is 8 >= 2: nothing
    drops); the fused program equal to the per-round loop, and to the
    reference's fused run in tokens and logs."""
    name, ref_cfg, cfg = _register(preset)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          ref_layers.init_tree(
                              ref_registry.param_specs(ref_cfg),
                              jax.random.key(0)))
    fam = (name, ref_cfg, cfg, params)
    assert moe._capacity(2, cfg) >= 2
    vocab = cfg.vocab_size
    rep = _port_rep(_port_engines(fam, 1, 2), vocab)
    solo_tokens = {}
    for req in list(rep.engines[0].queue):
        solo = _port_rep(_port_engines(fam, 1, 2), vocab, reqs=0)
        solo.submit(0, api.Request(rid=req.rid,
                                   prompt=np.array(req.prompt, np.int32),
                                   max_new_tokens=req.max_new_tokens))
        solo.run()
        solo_tokens[req.rid] = solo.engines[0].completed[0].tokens_out
    r_u = rep.run()
    assert _tokens(rep) == solo_tokens, "batched != solo decode"
    rep_f = _port_rep(rep.engines, vocab)
    r_f = rep_f.run(fused=True)
    _assert_conformant(rep, r_u, rep_f, r_f)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(fam, 1, 2), vocab)
    r_ref = ref_rep.run(fused=True)
    assert r_ref.extras["serve"]["fused"] is True
    assert rep_f.completed() == ref_rep.completed()
    _assert_logs_equal(r_f.extras["delivery_logs"],
                       r_ref.extras["delivery_logs"])
