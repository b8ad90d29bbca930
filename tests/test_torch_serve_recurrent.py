"""The recurrent families on the port's serve plane, in float32 on the
CPU: mamba2 (ssm) and zamba2 (hybrid) at the reference's ``reduced()``
presets, through ``ServeEngine`` and ``ReplicatedEngine.run`` per round
and fused.

* The ports of ``tests/test_serve_fused.py::test_recurrent_family_serves``
  (continuous batching with idle slots and mid-ring admissions gives the
  same tokens as serving each request alone — the validity-masked decode
  carries the slots it does not serve through bit-unchanged) and
  ``::test_fused_serves_recurrent_family`` (the fused program equals the
  per-round loop exactly), each also against the reference's tokens.
* ``ReplicatedEngine.run`` against the reference's engine on both
  backend pairs (port ``graph`` vs reference ``graph``, port ``kernel``
  vs reference ``pallas``): tokens, per-topic delivery logs, integer
  report fields, serve counters and round traces exactly equal, with
  ``test_torch_serve``'s scenarios.

Parameters are the reference's initialisation (``jax.random.key(0)``)
cast to float32 and carried across with ``params_from_numpy``; the
reference runs with ``repro.models.layers.DEFAULT_DTYPE`` patched to
float32 and its cache cast to float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.runtime import Runtime as RefRuntime
from repro.serve import engine as ref_engine
from repro.serve.fanout import ReplicatedEngine as RefReplicatedEngine
from repro_torch import api
from repro_torch.models import convert, registry
from test_torch_serve import SCENARIOS, _assert_logs_equal, _run_both
from test_torch_serve_fused import _assert_conformant

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

PRESETS = ("mamba2-2.7b", "zamba2-2.7b")
BACKENDS = [("graph", "graph"), ("kernel", "pallas")]
MAX_LEN = 48


def _register(preset):
    """The reduced preset under a test name in both registries."""
    name = f"serve-recurrent-{preset.split('-')[0]}"
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


def _port_engines(family, n, slots):
    name, _, cfg, params = family
    p = convert.params_from_numpy(params, cfg, "cpu", torch.float32)
    return [api.ServeEngine(name, p, cfg,
                            api.EngineConfig(max_batch=slots,
                                             max_len=MAX_LEN),
                            device="cpu") for _ in range(n)]


def _ref_engines(family, n, slots):
    name, ref_cfg, _, params = family
    p = jax.tree.map(jnp.asarray, params)
    engines = []
    for _ in range(n):
        eng = ref_engine.ServeEngine(
            name, p, ref_cfg,
            ref_engine.EngineConfig(max_batch=slots, max_len=MAX_LEN),
            RefRuntime())
        eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
        engines.append(eng)
    return engines


def _requests(request_cls, vocab, replicas=1, reqs=3, prompt=3,
              new_tokens=4, seed=7):
    """``tests/test_serve_fused.py``'s ``_rep`` requests."""
    rng = np.random.default_rng(seed)
    return [[request_cls(rid=g * 10 + i,
                         prompt=rng.integers(1, vocab, size=prompt)
                         .astype(np.int32),
                         max_new_tokens=new_tokens)
             for i in range(reqs)] for g in range(replicas)]


def _rep(engines, rep_cls, request_cls, vocab, *, reqs=3, backend="graph",
         **kw):
    rep = rep_cls(engines, subscribers_per_replica=1, window=4,
                  backend=backend, **kw)
    rep.reset()
    for g, per in enumerate(_requests(request_cls, vocab,
                                      replicas=len(engines), reqs=reqs)):
        for req in per:
            rep.submit(g, req)
    return rep


def _port_rep(engines, vocab, **kw):
    return _rep(engines, api.ReplicatedEngine, api.Request, vocab,
                device="cpu", **kw)


def _ref_rep(engines, vocab, **kw):
    return _rep(engines, RefReplicatedEngine, ref_engine.Request, vocab,
                **kw)


def _tokens(rep):
    return {r.rid: r.tokens_out for e in rep.engines for r in e.completed}


def test_recurrent_family_serves(monkeypatch, family):
    """Batched serving (2 slots, 3 requests: mid-ring admissions beside
    idle and busy slots) gives each request the tokens it gets served
    alone; and the reference's batched tokens."""
    vocab = family[2].vocab_size
    engines = _port_engines(family, 1, 2)
    rep = _port_rep(engines, vocab)
    solo_tokens = {}
    for req in list(rep.engines[0].queue):
        solo = _port_rep(_port_engines(family, 1, 2), vocab, reqs=0)
        solo.submit(0, api.Request(rid=req.rid,
                                   prompt=np.array(req.prompt, np.int32),
                                   max_new_tokens=req.max_new_tokens))
        solo.run()
        solo_tokens[req.rid] = solo.engines[0].completed[0].tokens_out
    report = rep.run()
    assert report.extras["serve"]["drained"]
    assert report.extras["serve"]["requests"] == 3
    got = _tokens(rep)
    assert got == solo_tokens, "batched != solo decode"
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(family, 1, 2), vocab)
    ref_rep.run()
    assert got == _tokens(ref_rep)


@pytest.mark.parametrize("backend,ref_backend", BACKENDS)
def test_fused_serves_recurrent_family(monkeypatch, family, backend,
                                       ref_backend):
    """The fused program over the recurrent decode equals the per-round
    loop exactly (tokens, logs, traces, report), and the reference's
    fused run in tokens and logs."""
    vocab = family[2].vocab_size
    engines = _port_engines(family, 1, 2)
    rep_u = _port_rep(engines, vocab, backend=backend)
    r_u = rep_u.run()
    rep_f = _port_rep(engines, vocab, backend=backend)
    r_f = rep_f.run(fused=True)
    _assert_conformant(rep_u, r_u, rep_f, r_f)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    ref_rep = _ref_rep(_ref_engines(family, 1, 2), vocab,
                       backend=ref_backend)
    r_ref = ref_rep.run(fused=True)
    assert r_ref.extras["serve"]["fused"] is True
    assert rep_f.completed() == ref_rep.completed()
    _assert_logs_equal(r_f.extras["delivery_logs"],
                       r_ref.extras["delivery_logs"])


@pytest.mark.parametrize("port_backend,ref_backend", BACKENDS)
@pytest.mark.parametrize("scenario", ["admission", "stall_fn"])
def test_replicated_engine_matches_the_reference(
        monkeypatch, family, port_backend, ref_backend, scenario):
    """Two replicas of two slots through ``test_torch_serve``'s
    scenarios (a stalled client; open-loop arrivals into a capped
    queue): every token, log, counter and trace exactly the
    reference's."""
    reports = _run_both(monkeypatch, _port_engines(family, 2, 2),
                        _ref_engines(family, 2, 2), port_backend,
                        ref_backend, SCENARIOS[scenario])
    serve = reports[0].extras["serve"]
    assert serve["tokens"] > 0 and serve["decode_steps"] > 0
    if scenario == "stall_fn":
        assert serve["drained"] and serve["stall_rounds"] == 3
    if scenario == "admission":
        assert serve["shed_requests"] > 0
