"""The port's dense decoder against the reference's, in float32.

Parameters are initialised by the reference (``jax.random.key``), cast to
float32 and carried across with ``params_from_numpy``; inputs come from
seeded numpy generators.  The reference runs with
``repro.models.layers.DEFAULT_DTYPE`` patched to float32 for the test (its
``embed`` casts to that dtype).  Logits are held at 2e-5 (the f32 bar of
``tests/test_kernels.py``: the two frameworks sum matmuls in different
orders); cache rows a step does not write must stay bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import masking as ref_masking
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.runtime import Runtime as RefRuntime
from repro_torch.models import (attention, convert, layers, masking,
                                registry, transformer)
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

ATOL = RTOL = 2e-5
DENSE = ("qwen1.5-0.5b", "qwen2-1.5b", "qwen3-1.7b", "qwen2-72b")

# the FAN shape of tests/test_serve_fanout.py, and a qk-norm / GQA-4 /
# QKV-bias variant
SHAPES = {
    "fan": dict(name="fanout-test", family="dense", n_layers=2,
                d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                vocab_size=512, head_dim=32, tie_embeddings=True),
    "qknorm": dict(name="qknorm-test", family="dense", n_layers=3,
                   d_model=96, n_heads=8, n_kv_heads=2, d_ff=160,
                   vocab_size=384, head_dim=16, qk_norm=True,
                   qkv_bias=True, rope_theta=1e6, tie_embeddings=False),
}


def _configs(key):
    return RefModelConfig(**SHAPES[key]), ModelConfig(**SHAPES[key])


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _ref_params(ref_cfg, seed):
    params = ref_layers.init_tree(ref_registry.param_specs(ref_cfg),
                                  jax.random.key(seed))
    # zero-initialised biases would hide a bias bug: draw them
    rng = np.random.default_rng(seed)
    params = _f32(params)
    for k in ("bq", "bk", "bv"):
        if k in params["layers"]["attn"]:
            shape = params["layers"]["attn"][k].shape
            params["layers"]["attn"][k] = rng.normal(
                0, 0.1, shape).astype(np.float32)
    return params


def _to_jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", DENSE)
def test_configs_and_param_counts_match_the_reference(name):
    want = ref_registry.get(name).cfg
    got = registry.get(name).cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_param_specs_match_the_reference(key):
    ref_cfg, cfg = _configs(key)
    want = jax.tree_util.tree_flatten_with_path(
        ref_registry.param_specs(ref_cfg),
        is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))[0]
    got = []

    def visit(tree, path):
        if isinstance(tree, layers.ParamSpec):
            got.append((path, tree))
            return
        for k in sorted(tree):
            visit(tree[k], path + (k,))

    visit(registry.param_specs(cfg), ())
    assert [tuple(p.key for p in path) for path, _ in want] == \
        [path for path, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert g.shape == w.shape and g.axes == w.axes and g.init == w.init
        assert g.dtype == torch.bfloat16


def test_initialize_follows_the_fan_in_rule():
    gen = torch.Generator().manual_seed(0)
    spec = layers.ParamSpec((4, 256, 8, 32), ("layers", "embed", "heads",
                                              "head_dim"))
    w = layers.initialize(spec, gen)
    assert w.dtype == torch.bfloat16 and w.shape == spec.shape
    # fan_in = 256 * 8 (the 'layers' axis excluded)
    np.testing.assert_allclose(w.float().std().item(),
                               1 / np.sqrt(256 * 8), rtol=0.05)
    assert torch.equal(layers.initialize(
        layers.ParamSpec((3,), ("embed",), init="ones"), gen),
        torch.ones(3, dtype=torch.bfloat16))
    specs = registry.param_specs(_configs("fan")[1])
    a = layers.init_tree(specs, torch.Generator().manual_seed(5))
    b = layers.init_tree(specs, torch.Generator().manual_seed(5))
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])


def test_rms_norm_and_rope_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    pos = rng.integers(0, 2048, size=(3, 5))
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6)),
        rtol=RTOL, atol=ATOL)


def test_sdpa_matches_the_reference():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    k = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    pos = np.array([0, 17, 39])
    want = ref_attention._sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False,
                               q_offset=jnp.asarray(pos),
                               kv_len=jnp.asarray(pos + 1))
    got = attention._sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False, q_offset=torch.from_numpy(pos),
                          kv_len=torch.from_numpy(pos + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _ref_decode(monkeypatch, ref_cfg, params, cache, tokens, pos):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    return ref_transformer.decode_step(
        _to_jnp(params), ref_cfg, _to_jnp(cache), jnp.asarray(tokens),
        jnp.asarray(pos, jnp.int32), RefRuntime())


@pytest.mark.parametrize("key", sorted(SHAPES))
@pytest.mark.parametrize("kernels", ["kernels", "plain"])
def test_masked_decode_steps_match_the_reference(monkeypatch, key,
                                                 kernels):
    """Several masked decode steps from a random cache: logits on the
    valid rows at 2e-5; written cache rows close; every other row of the
    cache bit-unchanged."""
    ref_cfg, cfg = _configs(key)
    b, s_max = 4, 24
    rng = np.random.default_rng(3)
    params = _ref_params(ref_cfg, seed=0)
    cache_shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.head_dim_)
    cache = {k: rng.normal(size=cache_shape).astype(np.float32)
             for k in ("k", "v")}
    specs = ref_attention.kv_cache_specs(ref_cfg, b, s_max)
    port_params = convert.params_from_numpy(params, cfg, "cpu",
                                            torch.float32)
    port_cache = convert.cache_from_numpy(cache, cfg, b, s_max, "cpu",
                                          torch.float32)
    rt = Runtime(kernels=kernels)
    ref_cache = _to_jnp(cache)
    for step in range(3):
        tokens = rng.integers(0, cfg.vocab_size, size=(b, 1),
                              dtype=np.int32)
        pos = rng.integers(0, s_max, size=b).astype(np.int32)
        valid = rng.random(b) < 0.6
        valid[step % b] = True
        before = {k: v.clone() for k, v in port_cache.items()}
        logits, new_cache = _ref_decode(monkeypatch, ref_cfg, params,
                                        ref_cache, tokens, pos)
        ref_cache = ref_masking.masked_update(specs, ref_cache, new_cache,
                                              jnp.asarray(valid))
        got, port_cache = transformer.decode_step(
            port_params, cfg, port_cache, torch.from_numpy(tokens),
            torch.from_numpy(pos), rt, valid=valid)
        got = got.numpy()
        assert got.shape == (b, cfg.vocab_size) and got.dtype == np.float32
        np.testing.assert_allclose(got[valid], np.asarray(logits)[valid],
                                   rtol=RTOL, atol=ATOL)
        for k in ("k", "v"):
            now = port_cache[k].numpy()
            np.testing.assert_allclose(now, np.asarray(ref_cache[k]),
                                       rtol=RTOL, atol=ATOL)
            written = np.zeros(cache_shape[:3], bool)
            written[:, np.flatnonzero(valid), pos[valid]] = True
            np.testing.assert_array_equal(now[~written],
                                          before[k].numpy()[~written])


def test_masking_rows_in_place():
    cfg = _configs("fan")[1]
    specs = attention.kv_cache_specs(cfg, 4, 6)
    rng = np.random.default_rng(4)
    old = {k: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
           for k, s in specs.items()}
    new = {k: torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
           for k, s in specs.items()}
    valid = np.array([True, False, True, False])
    want = ref_masking.masked_update(
        ref_attention.kv_cache_specs(_configs("fan")[0], 4, 6),
        {k: jnp.asarray(v.numpy()) for k, v in old.items()},
        {k: jnp.asarray(v.numpy()) for k, v in new.items()},
        jnp.asarray(valid))
    ptrs = {k: v.data_ptr() for k, v in old.items()}
    got = masking.masked_update(specs, old, new, valid)
    for k in specs:
        assert got[k].data_ptr() == ptrs[k]          # written in place
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert masking.masked_update(specs, got, got, valid) is not None
    zeroed = masking.reset_rows(specs, got, valid)
    for k in specs:
        assert zeroed[k].data_ptr() == ptrs[k]
        assert not zeroed[k][:, valid].any()
        np.testing.assert_array_equal(zeroed[k][:, ~valid].numpy(),
                                      np.asarray(want[k])[:, ~valid])


def test_convert_checks_keys_and_shapes():
    ref_cfg, cfg = _configs("fan")
    params = _ref_params(ref_cfg, seed=1)
    bad = jax.tree.map(lambda x: x, params)
    bad["embed"] = bad["embed"][:, :5]
    with pytest.raises(ValueError, match="params.embed"):
        convert.params_from_numpy(bad, cfg, "cpu")
    extra = dict(params, lm_head=params["embed"].T)
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_numpy(extra, cfg, "cpu")
    got = convert.params_from_numpy(params, cfg, "cpu")
    assert got["embed"].dtype == torch.bfloat16          # the spec's dtype


def test_unported_families_and_bad_runtime_raise():
    cfg = dataclasses.replace(_configs("fan")[1], family="moe")
    with pytest.raises(NotImplementedError, match="item 12"):
        registry.param_specs(cfg)
    with pytest.raises(NotImplementedError, match="item 12"):
        registry.cache_specs(cfg, ShapeConfig("x", 8, 2, "decode"))
    with pytest.raises(ValueError, match="kernels"):
        Runtime(kernels="cuda")
    with pytest.raises(KeyError, match="no-such-model"):
        registry.get("no-such-model")
