"""The port's recurrent families against the reference, in float32: the
Mamba2 decode (``ssm.mamba_decode_block``, ``registry._ssm_decode_step``)
and the Zamba2 hybrid (``models/hybrid.py``: forward, loss, decode).

The configs are the reference's ``reduced()`` presets of mamba2-2.7b and
zamba2-2.7b (and a mamba2 variant with two B/C groups).  Parameters are
initialised by the reference, cast to float32 and carried across with
``params_from_numpy``; ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b``
are drawn at random, so that a zero or one init cannot hide a bug.  The
decode states are drawn at random too and carried across with
``cache_from_numpy``.  The reference runs with
``repro.models.layers.DEFAULT_DTYPE`` patched to float32, its Pallas
kernels in interpret mode (``attn_impl`` / ``ssm_impl="pallas"``) and its
XLA path.  The reference's decode returns new states for every row and
masks them with ``masking.masked_update``; the port writes the valid rows
in place, so the rows a step does not write must stay bit-unchanged.

Tolerances: decode logits and states 2e-5 a step (the float32 kernel bar
of ``tests/test_kernels.py``), the hybrid's hidden states and loss 1e-4
(the SSD bar: the scan is chunked in both), a forward of S tokens
against S decode steps 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.models import hybrid as ref_hybrid
from repro.models import layers as ref_layers
from repro.models import masking as ref_masking
from repro.models import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.models.runtime import Runtime as RefRuntime
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.models import (convert, hybrid, layers, masking, registry,
                                ssm, transformer)
from repro_torch.models.config import ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import steps

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

ATOL = RTOL = 2e-5
SSD_TOL = 1e-4
PRESETS = ("mamba2-2.7b", "zamba2-2.7b")
CASES = ("mamba2", "mamba2-groups", "zamba2")
DRAWS = {"a_log": (0, 0.5), "dt_bias": (0, 0.5), "d_skip": (1, 0.3),
         "conv_b": (0, 0.1)}


def _configs(case):
    """(reference config, port config) of one case."""
    preset = "zamba2-2.7b" if case == "zamba2" else "mamba2-2.7b"
    ref_cfg = ref_registry.get(preset).cfg.reduced()
    if case == "mamba2-groups":
        ref_cfg = dataclasses.replace(
            ref_cfg, n_layers=3,
            ssm=dataclasses.replace(ref_cfg.ssm, n_groups=2))
    cfg = registry.get(preset).cfg.reduced()
    return ref_cfg, dataclasses.replace(
        cfg, n_layers=ref_cfg.n_layers,
        ssm=dataclasses.replace(cfg.ssm, n_groups=ref_cfg.ssm.n_groups))


def _ssm_subtree(params):
    return params["mamba_layers" if "mamba_layers" in params
                  else "layers"]["ssm"]


def _ref_params(ref_cfg, seed):
    """The reference's initialisation as float32 numpy, with the ssm's
    per-head vectors and conv bias drawn."""
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          ref_layers.init_tree(
                              ref_registry.param_specs(ref_cfg),
                              jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    sub = _ssm_subtree(params)
    for k, (mu, sd) in DRAWS.items():
        sub[k] = rng.normal(mu, sd, sub[k].shape).astype(np.float32)
    return params


def _both(case, seed):
    ref_cfg, cfg = _configs(case)
    params = _ref_params(ref_cfg, seed)
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, params),
            convert.params_from_numpy(params, cfg, "cpu", torch.float32))


def _ref_cache_specs(ref_cfg, b, s_max):
    return ref_registry.cache_specs(
        ref_cfg, RefShapeConfig("x", s_max, b, "decode"))


def _random_cache(ref_cfg, b, s_max, rng):
    """A random decode state of the reference's layout, float32 numpy."""
    specs = _ref_cache_specs(ref_cfg, b, s_max)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), specs,
        is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(b, s), dtype=np.int32)


@pytest.fixture
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


def _close(got, want, tol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-2.7b", "qwen1.5-0.5b",
                                  "qwen2-1.5b", "qwen2-72b", "qwen3-1.7b",
                                  "zamba2-2.7b"])
def test_reduced_presets_match_the_reference(name):
    """Every config the port registers, full and ``reduced()``, equals the
    reference's; the parameter counts too."""
    want, got = ref_registry.get(name).cfg, registry.get(name).cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.param_count() == want.param_count()
    assert got.reduced().param_count() == want.reduced().param_count()


def _spec_rows(tree, is_ref):
    if is_ref:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))[0]
        return [(tuple(p.key for p in path), s.shape, s.axes,
                 str(np.dtype(s.dtype))) for path, s in flat]
    rows = []

    def visit(t, path):
        if isinstance(t, layers.ParamSpec):
            rows.append((path, t.shape, t.axes,
                         str(t.dtype).split(".")[-1]))
            return
        for k in sorted(t):
            visit(t[k], path + (k,))

    visit(tree, ())
    return rows


@pytest.mark.parametrize("case", CASES)
def test_param_and_cache_specs_match_the_reference(case):
    """Paths, shapes, logical axes, inits and dtypes of the parameter
    specs and the decode-state specs (``ssm_state`` float32)."""
    ref_cfg, cfg = _configs(case)
    ref_p = ref_registry.param_specs(ref_cfg)
    got_p = registry.param_specs(cfg)
    assert _spec_rows(got_p, False) == _spec_rows(ref_p, True)
    assert [s.init for s in layers.spec_leaves(got_p)] == [
        s.init for s in jax.tree.leaves(
            ref_p, is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))]
    want = _spec_rows(_ref_cache_specs(ref_cfg, 3, 40), True)
    got = _spec_rows(registry.cache_specs(cfg, ShapeConfig("x", 40, 3,
                                                           "decode")), False)
    assert got == want
    assert dict((r[0], r[3]) for r in got)[("ssm_state",)] == "float32"


# ---------------------------------------------------------------------------
# Mamba2 decode
# ---------------------------------------------------------------------------

def _masked(new, old, valid):
    """The reference's masked state: new at the valid rows (axis 0)."""
    m = np.asarray(valid).reshape(-1, *[1] * (np.ndim(old) - 1))
    return np.where(m, np.asarray(new), np.asarray(old))


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("kernels", ["kernels", "plain"])
@pytest.mark.parametrize("case", ["mamba2", "mamba2-groups"])
def test_mamba_decode_block_matches_the_reference(case, kernels):
    """Six steps of one block from a random state with mixed valid rows:
    the output at 2e-5 on every row, both states at 2e-5 against the
    reference's masked states, and the rows a step does not write
    bit-unchanged."""
    ref_cfg, cfg, ref_p, p = _both(case, seed=1)
    b = 4
    rng = np.random.default_rng(2)
    lp = transformer.layer_params(p["layers"], 1)["ssm"]
    ref_lp = jax.tree.map(lambda a: a[1], ref_p["layers"])["ssm"]
    cache = _random_cache(ref_cfg, b, 8, rng)
    ss_ref, cs_ref = cache["ssm_state"][1], cache["conv_state"][1]
    ss = torch.from_numpy(ss_ref.copy())
    cs = torch.from_numpy(cs_ref.copy())
    rt = Runtime(kernels=kernels)
    for step in range(6):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        valid = rng.random(b) < 0.6
        valid[step % b] = True
        valid[(step + 1) % b] = False
        want, ss_new, cs_new = ref_ssm.mamba_decode_block(
            ref_lp, ref_cfg, jnp.asarray(x), jnp.asarray(ss_ref),
            jnp.asarray(cs_ref))
        ss_ref = _masked(ss_new, ss_ref, valid)
        cs_ref = _masked(cs_new, cs_ref, valid)
        before = (ss.clone(), cs.clone())
        got = ssm.mamba_decode_block(lp, cfg, torch.from_numpy(x), ss, cs,
                                     rt, masking.valid_rows(valid, "cpu"))
        assert got.shape == (b, 1, cfg.d_model)
        _close(got, want, what=f"step {step} output")
        _close(ss, ss_ref, what=f"step {step} ssm_state")
        _close(cs, cs_ref, what=f"step {step} conv_state")
        assert torch.equal(ss[~valid], before[0][~valid])
        assert torch.equal(cs[~valid], before[1][~valid])


def _decode_both(case, seed, b, s_max, steps_, kernels):
    """``steps_`` decode steps of the whole model on both packages from
    one random state, with mixed valid rows (host rows) and per-row
    positions.
    Yields per step (port logits, reference logits, port cache, reference
    cache as numpy, valid, the port cache before the step)."""
    ref_cfg, cfg, ref_p, p = _both(case, seed)
    rng = np.random.default_rng(seed + 1)
    cache = _random_cache(ref_cfg, b, s_max, rng)
    port = convert.cache_from_numpy(cache, cfg, b, s_max, "cpu",
                                    torch.float32)
    specs = _ref_cache_specs(ref_cfg, b, s_max)
    ref_cache = jax.tree.map(jnp.asarray, cache)
    ref_decode = ref_registry.Arch(ref_cfg).decode_fn()
    decode = registry.Arch(cfg).decode_fn()
    rt = Runtime(kernels=kernels)
    pos = rng.integers(0, s_max // 2, size=b).astype(np.int32)
    for step in range(steps_):
        tokens = rng.integers(0, cfg.vocab_size, size=(b, 1), dtype=np.int32)
        valid = rng.random(b) < 0.6
        valid[step % b] = True
        valid[(step + 1) % b] = False
        want, new = ref_decode(ref_p, ref_cfg, ref_cache,
                               jnp.asarray(tokens), jnp.asarray(pos),
                               RefRuntime())
        ref_cache = ref_masking.masked_update(specs, ref_cache, new,
                                              jnp.asarray(valid))
        before = {k: v.clone() for k, v in port.items()}
        got, same = decode(p, cfg, port, torch.from_numpy(tokens),
                           torch.from_numpy(pos), rt, valid)
        assert same is port
        yield got, want, port, ref_cache, valid, before
        pos = pos + valid.astype(np.int32)


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("kernels", ["kernels", "plain"])
@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_the_reference(case, kernels):
    """Six steps of ``Arch.decode_fn()`` (``_ssm_decode_step`` or
    ``hybrid.decode_step``) with the caches carried across: the valid
    rows' logits and every cache leaf at 2e-5 a step; the rows a step
    does not write stay bit-unchanged (batch axis 1 of the ssm's leaves
    and the K/V caches, axis 2 of the hybrid's states)."""
    _, cfg = _configs(case)
    specs = registry.cache_specs(cfg, ShapeConfig("x", 24, 4, "decode"))
    for step, (got, want, port, ref_cache, valid, before) in enumerate(
            _decode_both(case, 3, 4, 24, 6, kernels)):
        assert got.shape == (4, cfg.vocab_size)
        # the valid rows (an invalid row of the hybrid attends over a K/V
        # row the port does not write and the reference writes, then
        # masks)
        _close(got[valid], np.asarray(want)[valid],
               what=f"step {step} logits")
        for k, v in port.items():
            _close(v, ref_cache[k], what=f"step {step} {k}")
            ax = masking.batch_axis(specs[k])
            idle = torch.from_numpy(np.flatnonzero(~valid))
            assert torch.equal(v.index_select(ax, idle),
                               before[k].index_select(ax, idle)), k


@pytest.mark.parametrize("kernels", ["kernels", "plain"])
@pytest.mark.parametrize("case", CASES)
def test_device_mask_decode_equals_host_rows(case, kernels):
    """The device-mask form of ``valid`` (what the fused serve program
    captures) against the host-row form: logits and every cache leaf bit
    for bit over six steps."""
    host = list(_decode_both_port(case, kernels, device_mask=False))
    dev = list(_decode_both_port(case, kernels, device_mask=True))
    assert len(host) == len(dev) == 6
    for (lh, ch), (ld, cd) in zip(host, dev):
        assert torch.equal(lh, ld)
        for k in ch:
            assert torch.equal(ch[k], cd[k]), k


def _decode_both_port(case, kernels, device_mask):
    """The port's side of :func:`_decode_both` alone."""
    ref_cfg, cfg = _configs(case)
    p = convert.params_from_numpy(_ref_params(ref_cfg, 5), cfg, "cpu",
                                  torch.float32)
    rng = np.random.default_rng(6)
    b, s_max = 4, 24
    cache = convert.cache_from_numpy(_random_cache(ref_cfg, b, s_max, rng),
                                     cfg, b, s_max, "cpu", torch.float32)
    decode = registry.Arch(cfg).decode_fn()
    pos = rng.integers(0, s_max // 2, size=b).astype(np.int32)
    for step in range(6):
        tokens = rng.integers(0, cfg.vocab_size, size=(b, 1), dtype=np.int32)
        valid = rng.random(b) < 0.5
        valid[step % b] = True
        logits, cache = decode(p, cfg, cache, torch.from_numpy(tokens),
                               torch.from_numpy(pos),
                               Runtime(kernels=kernels),
                               torch.from_numpy(valid) if device_mask
                               else valid)
        yield logits, {k: v.clone() for k, v in cache.items()}
        pos = pos + valid.astype(np.int32)


@pytest.mark.parametrize("case", CASES)
def test_admission_reset_zeroes_the_slot_state(case):
    """``reset_rows`` (host rows and device mask) and ``reset_slot`` zero
    exactly the admitted slot's rows of every leaf — the SSM and conv
    states included — and leave every other row bit-unchanged."""
    ref_cfg, cfg = _configs(case)
    b, s_max = 4, 16
    specs = registry.cache_specs(cfg, ShapeConfig("x", s_max, b, "decode"))
    rng = np.random.default_rng(7)
    fresh = convert.cache_from_numpy(_random_cache(ref_cfg, b, s_max, rng),
                                     cfg, b, s_max, "cpu", torch.float32)
    valid = np.array([False, True, False, False])
    for how in ("rows", "mask", "slot"):
        cache = {k: v.clone() for k, v in fresh.items()}
        if how == "rows":
            masking.reset_rows(specs, cache, valid)
        elif how == "mask":
            masking.reset_rows(specs, cache, torch.from_numpy(valid))
        else:
            masking.reset_slot(specs, cache, 1)
        for k, spec in layers.map_specs(lambda s: s, specs).items():
            ax = masking.batch_axis(spec)
            assert not cache[k].select(ax, 1).any(), (how, k)
            for row in (0, 2, 3):
                assert torch.equal(cache[k].select(ax, row),
                                   fresh[k].select(ax, row)), (how, k)


# ---------------------------------------------------------------------------
# the hybrid's full-sequence forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hybrid_forward_and_loss_match_the_reference(impl):
    """zamba2 reduced (4 layers, attn_every 2): the hidden states before
    the final norm and the loss (with and without a mask) at 1e-4 against
    the reference's pallas (interpret mode) and xla paths; the loss also
    through ``make_serve_step("prefill")``."""
    ref_cfg, cfg, ref_p, p = _both("zamba2", seed=8)
    tokens = _tokens(cfg, 2, 64, seed=9)
    rt_ref = RefRuntime(attn_impl=impl, ssm_impl=impl)
    x = jnp.take(ref_p["embed"], jnp.asarray(tokens), axis=0)
    want = ref_hybrid.forward(ref_p, ref_cfg, x, rt_ref)
    got = hybrid.forward(p, cfg, transformer.embed(p, cfg,
                                                   torch.from_numpy(tokens)),
                         Runtime())
    _close(got, want, SSD_TOL, "hidden")
    mask = (np.random.default_rng(10).random((2, 64)) < 0.7).astype(
        np.float32)
    arch = registry.Arch(cfg)
    for m in (None, mask):
        batch_ref = {"tokens": jnp.asarray(tokens)}
        batch = {"tokens": torch.from_numpy(tokens)}
        if m is not None:
            batch_ref["mask"] = jnp.asarray(m)
            batch["mask"] = torch.from_numpy(m)
        want = float(ref_hybrid.lm_loss(ref_p, ref_cfg, batch_ref, rt_ref))
        got = arch.loss_fn()(p, cfg, batch, Runtime())
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=SSD_TOL)
        served = steps.make_serve_step(arch, Runtime(kernels="plain"),
                                       "prefill")(p, batch)
        np.testing.assert_allclose(float(served), want, rtol=SSD_TOL)


@pytest.mark.parametrize("kernels,dtype", [("kernels", torch.float32),
                                           ("plain", torch.float32),
                                           ("plain", torch.float64)])
@pytest.mark.parametrize("case", CASES)
def test_forward_equals_decoding_the_sequence(case, kernels, dtype):
    """The full-sequence forward over S = 64 tokens (two SSD chunks)
    against 64 decode steps from a zero state, through the same
    ``Arch`` entry points: the logits at every position within 1e-4 in
    float32; in float64 (the plain versions keep it) within 1e-9 — the
    two orders compute one function."""
    _, cfg, _, p = _both(case, seed=11)
    tol = SSD_TOL if dtype == torch.float32 else 1e-9
    if dtype == torch.float64:
        p = tree_util.map(lambda t: t.double(), p)
    b, s = 2, 64
    tokens = torch.from_numpy(_tokens(cfg, b, s, seed=12))
    arch = registry.Arch(cfg)
    rt = Runtime(kernels=kernels)
    if cfg.family == "hybrid":
        h = hybrid.hidden(p, cfg, tokens, rt)
    else:
        h = registry._ssm_hidden(p, cfg, tokens, rt)
    full = h @ p["lm_head"]
    specs = arch.cache_specs(ShapeConfig("x", s, b, "decode"))
    cache = layers.map_specs(lambda sp: torch.zeros(sp.shape, dtype=dtype),
                             specs)
    decode = arch.decode_fn()
    for t in range(s):
        logits, cache = decode(p, cfg, cache, tokens[:, t:t + 1],
                               torch.full((b,), t, dtype=torch.int32), rt)
        assert logits.dtype == dtype
        _close(logits, full[:, t], tol, f"position {t}")


# ---------------------------------------------------------------------------
# the serve-side pieces: cache dtypes, conversion, the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_engine_keeps_the_ssm_state_in_float32(preset):
    """With bfloat16 weights the engine allocates ``ssm_state`` in
    float32 (its spec's dtype, as the reference does) and every other
    leaf in the weights' dtype; ``cache_from_numpy`` follows the same
    rule."""
    cfg = dataclasses.replace(registry.get(preset).cfg.reduced(),
                              name=f"{preset}-bf16-test")
    registry.register(cfg.name, lambda: cfg)
    params = registry.Arch(cfg).init_params(0, "cpu", torch.bfloat16)
    eng = api.ServeEngine(cfg.name, params, cfg,
                          api.EngineConfig(max_batch=2, max_len=16),
                          device="cpu")
    for k, v in eng.cache.items():
        want = torch.float32 if k == "ssm_state" else torch.bfloat16
        assert v.dtype == want, k
    spec = layers.ParamSpec((2,), ("batch",), dtype=torch.float32)
    assert spec.dtype_for(torch.bfloat16) == torch.float32
    assert layers.ParamSpec((2,), ("batch",)).dtype_for(torch.float16) == \
        torch.float16
    host = layers.map_specs(lambda s: np.zeros(s.shape, np.float32),
                            eng.cache_specs)
    carried = convert.cache_from_numpy(host, cfg, 2, 16, "cpu",
                                       torch.bfloat16)
    assert {k: v.dtype for k, v in carried.items()} == \
        {k: v.dtype for k, v in eng.cache.items()}
    with pytest.raises(ValueError, match="cache.ssm_state"):
        convert.cache_from_numpy(dict(host, ssm_state=host["conv_state"]),
                                 cfg, 2, 16, "cpu")
    # one masked step through the engine's decode body on bf16 weights
    logits, cache = eng.decode(params, eng.cache,
                               torch.zeros((2, 1), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32),
                               np.array([True, False]))
    assert logits.shape == (2, cfg.vocab_size)
    assert all(cache[k] is eng.cache[k] for k in cache)     # in place
    assert bool(torch.isfinite(logits.float()).all())
    ax = masking.batch_axis(eng.cache_specs["ssm_state"])
    assert cache["ssm_state"].select(ax, 0).abs().sum() > 0
    assert not cache["ssm_state"].select(ax, 1).any()


def test_recurrent_entry_points_work():
    """``decode_fn``, ``cache_specs`` and ``make_serve_step("decode")``
    of both recurrent families; their ``prefill_fn`` is None (the
    forward is the prefill); both train (a hybrid Trainer takes a
    step)."""
    for preset in PRESETS:
        arch = registry.get(preset)
        assert arch.prefill_fn() is None
        assert callable(arch.decode_fn())
        specs = arch.cache_specs(ShapeConfig("x", 2048, 8, "decode"))
        assert specs["ssm_state"].dtype == torch.float32
        assert callable(steps.make_serve_step(arch, Runtime(), "decode"))
    zamba = registry.get("zamba2-2.7b")
    full = zamba.cache_specs(ShapeConfig("x", 2048, 8, "decode"))
    assert full["ssm_state"].shape == (9, 6, 8, 80, 64, 64)
    assert full["k"].shape == (9, 8, 2048, 32, 80)
    assert callable(steps.make_train_step(zamba, Runtime()))
    trainer = api.Trainer("zamba2-2.7b", zamba.cfg.reduced(),
                          api.TrainConfig(steps=1, seq_len=32,
                                          global_batch=2, log_every=1),
                          device="cpu")
    params, _ = trainer.run()
    assert np.isfinite(trainer.history[0]["loss"])
    assert params["shared_block"]["attn"]["wq"].dtype == torch.bfloat16
    assert callable(steps.make_train_step(registry.get("mamba2-2.7b"),
                                          Runtime()))


def test_decode_step_through_make_serve_step():
    """``make_serve_step(arch, rt, "decode")`` is ``decode_fn`` over every
    row: equal logits and caches, bit for bit."""
    ref_cfg, cfg = _configs("zamba2")
    p = convert.params_from_numpy(_ref_params(ref_cfg, 13), cfg, "cpu",
                                  torch.float32)
    rng = np.random.default_rng(14)
    host = _random_cache(ref_cfg, 2, 16, rng)
    a = convert.cache_from_numpy(host, cfg, 2, 16, "cpu", torch.float32)
    b = convert.cache_from_numpy(host, cfg, 2, 16, "cpu", torch.float32)
    tokens = torch.from_numpy(_tokens(cfg, 2, 1, 15))
    pos = torch.tensor([3, 5], dtype=torch.int32)
    arch = registry.Arch(cfg)
    got, _ = steps.make_serve_step(arch, Runtime(), "decode")(
        p, a, {"tokens": tokens}, pos)
    want, _ = arch.decode_fn()(p, cfg, b, tokens, pos, Runtime())
    assert torch.equal(got, want)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_hybrid_specs_refuse_a_ragged_period():
    cfg = dataclasses.replace(registry.get("zamba2-2.7b").cfg.reduced(),
                              n_layers=5)
    with pytest.raises(ValueError, match="attn_every"):
        registry.param_specs(cfg)
