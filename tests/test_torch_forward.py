"""The port's full-sequence forward against the reference, in float32.

The dense family's ``forward``, ``lm_loss`` and ``prefill`` and the
Mamba2 family's ``_ssm_lm_loss`` run on the port (CPU, so every kernel
site runs its plain version) and on the JAX package with
``repro.models.layers.DEFAULT_DTYPE`` patched to float32, through the
reference's Pallas kernels in interpret mode (``attn_impl`` /
``ssm_impl="pallas"``) and through its XLA path.  Parameters are
initialised by the reference and carried across with
``params_from_numpy``; the biases, ``a_log``, ``dt_bias``, ``d_skip`` and
``conv_b`` are drawn at random so that a zero or one init cannot hide a
bug.  Tolerances, stated per test: hidden states and logits 2e-5 (the
float32 kernel bar of ``tests/test_kernels.py``), losses 1e-5 relative,
the ssm path 1e-4 (the SSD bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import SSMConfig as RefSSMConfig
from repro.models.runtime import Runtime as RefRuntime
from repro_torch import api
from repro_torch.models import convert, layers, registry, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig, SSMConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import steps

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

ATOL = RTOL = 2e-5
SSM_TOL = 1e-4

DENSE = {
    "fan": dict(name="fanout-test", family="dense", n_layers=2,
                d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                vocab_size=512, head_dim=32, tie_embeddings=True),
    "qknorm": dict(name="qknorm-test", family="dense", n_layers=3,
                   d_model=96, n_heads=8, n_kv_heads=2, d_ff=160,
                   vocab_size=384, head_dim=16, qk_norm=True,
                   qkv_bias=True, rope_theta=1e6, tie_embeddings=False),
}
SSM = dict(name="ssm-test", family="ssm", n_layers=3, d_model=64,
           n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=256, head_dim=16)
SSM_INNER = dict(d_state=16, head_dim=16, expand=2, chunk=8, n_groups=2)


def _dense(key):
    return RefModelConfig(**DENSE[key]), ModelConfig(**DENSE[key])


def _ssm():
    return (RefModelConfig(**SSM, ssm=RefSSMConfig(**SSM_INNER)),
            ModelConfig(**SSM, ssm=SSMConfig(**SSM_INNER)))


def _ref_params(ref_cfg, seed):
    """The reference's initialisation as float32 numpy, with the biases
    and the ssm's per-head vectors and conv bias drawn."""
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          ref_layers.init_tree(
                              ref_registry.param_specs(ref_cfg),
                              jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    draws = {"bq": (0, 0.1), "bk": (0, 0.1), "bv": (0, 0.1),
             "a_log": (0, 0.5), "dt_bias": (0, 0.5), "d_skip": (1, 0.3),
             "conv_b": (0, 0.1)}
    for sub in params["layers"].values():
        for k, (mu, sd) in draws.items():
            if k in sub:
                sub[k] = rng.normal(mu, sd, sub[k].shape).astype(np.float32)
    return params


def _both(ref_cfg, cfg, seed):
    params = _ref_params(ref_cfg, seed)
    return (jax.tree.map(jnp.asarray, params),
            convert.params_from_numpy(params, cfg, "cpu", torch.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(b, s), dtype=np.int32)


@pytest.fixture
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


# ---------------------------------------------------------------------------
# dense family
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("key", sorted(DENSE))
def test_dense_forward_and_loss_match_the_reference(key, impl):
    """Hidden states at 2e-5; the loss (with a mask) at 1e-5 relative."""
    ref_cfg, cfg = _dense(key)
    ref_p, p = _both(ref_cfg, cfg, seed=1)
    rt_ref = RefRuntime(attn_impl=impl)
    tokens = _tokens(cfg, 2, 40, seed=2)
    mask = (np.random.default_rng(3).random((2, 40)) < 0.8).astype(
        np.float32)
    x_ref = ref_transformer.embed(ref_p, ref_cfg, jnp.asarray(tokens),
                                  rt_ref)
    h_ref, _ = ref_transformer.forward(ref_p, ref_cfg, x_ref, rt_ref)
    x = transformer.embed(p, cfg, torch.from_numpy(tokens))
    h, aux = transformer.forward(p, cfg, x, Runtime())
    assert h.shape == (2, 40, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=RTOL,
                               atol=ATOL)
    for m in (None, mask):
        batch_ref = {"tokens": jnp.asarray(tokens)}
        batch = {"tokens": torch.from_numpy(tokens)}
        if m is not None:
            batch_ref["mask"] = jnp.asarray(m)
            batch["mask"] = torch.from_numpy(m)
        want = float(ref_transformer.lm_loss(ref_p, ref_cfg, batch_ref,
                                             rt_ref))
        got = registry.Arch(cfg).loss_fn()(p, cfg, batch, Runtime())
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("kernels", ["kernels", "plain"])
@pytest.mark.parametrize("key", sorted(DENSE))
def test_prefill_matches_the_reference(key, kernels):
    """Last-position logits and every cache entry at 2e-5, through
    ``Arch.prefill_fn`` and ``make_serve_step``."""
    ref_cfg, cfg = _dense(key)
    ref_p, p = _both(ref_cfg, cfg, seed=4)
    tokens = _tokens(cfg, 3, 21, seed=5)
    want, cache_ref = ref_transformer.prefill(ref_p, ref_cfg,
                                              jnp.asarray(tokens),
                                              RefRuntime())
    rt = Runtime(kernels=kernels)
    step = steps.make_serve_step(registry.Arch(cfg), rt, "prefill")
    got, cache = step(p, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for k in ("k", "v"):
        assert cache[k].shape == (cfg.n_layers, 3, 21, cfg.n_kv_heads,
                                  cfg.head_dim_)
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(cache_ref[k]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("key", sorted(DENSE))
def test_prefill_then_decode_continues_the_sequence(key):
    """Prefill of S tokens into a preallocated cache (rows >= S left
    bit-unchanged), then one decode step at position S, equals the last
    logits of a prefill of the S + 1 tokens (1e-4: two attention
    orders)."""
    ref_cfg, cfg = _dense(key)
    _, p = _both(ref_cfg, cfg, seed=6)
    b, s, s_max = 2, 17, 24
    tokens = torch.from_numpy(_tokens(cfg, b, s + 1, seed=7))
    rng = np.random.default_rng(8)
    shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.head_dim_)
    cache = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for k in ("k", "v")}
    tail = {k: v[:, :, s:].clone() for k, v in cache.items()}
    rt = Runtime()
    arch = registry.Arch(cfg)
    _, same = arch.prefill_fn()(p, {"tokens": tokens[:, :s]}, rt,
                                cache=cache)
    assert same is cache
    for k in ("k", "v"):
        assert torch.equal(cache[k][:, :, s:], tail[k])
    step = steps.make_serve_step(arch, rt, "decode")
    got, _ = step(p, cache, {"tokens": tokens[:, s:]},
                  torch.full((b,), s, dtype=torch.int32))
    want, full = arch.prefill_fn()(p, {"tokens": tokens}, rt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k][:, :, :s + 1].numpy(),
                                   full[k].numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="S_max"):
        transformer.prefill(p, cfg, tokens, rt,
                            cache={k: v[:, :, :s] for k, v in cache.items()})


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(9)
    logits = (3 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = ref_layers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# ssm family
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssm_loss_matches_the_reference(impl):
    """``_ssm_lm_loss`` (3 layers, 2 B/C groups, chunk 8) at 1e-4, with
    and without a mask; also through ``make_serve_step("prefill")``,
    which runs the loss forward for the recurrent families."""
    ref_cfg, cfg = _ssm()
    ref_p, p = _both(ref_cfg, cfg, seed=10)
    tokens = _tokens(cfg, 2, 32, seed=11)
    mask = (np.random.default_rng(12).random((2, 32)) < 0.7).astype(
        np.float32)
    rt_ref = RefRuntime(ssm_impl=impl)
    arch = registry.Arch(cfg)
    for m in (None, mask):
        batch_ref = {"tokens": jnp.asarray(tokens)}
        batch = {"tokens": torch.from_numpy(tokens)}
        if m is not None:
            batch_ref["mask"] = jnp.asarray(m)
            batch["mask"] = torch.from_numpy(m)
        want = float(ref_registry._ssm_lm_loss(ref_p, ref_cfg, batch_ref,
                                               rt_ref))
        got = arch.loss_fn()(p, cfg, batch, Runtime())
        np.testing.assert_allclose(float(got), want, rtol=SSM_TOL)
        served = steps.make_serve_step(arch, Runtime(kernels="plain"),
                                       "prefill")(p, batch)
        np.testing.assert_allclose(float(served), want, rtol=SSM_TOL)


@pytest.mark.usefixtures("f32_reference")
def test_mamba_block_matches_the_reference():
    """One block's output at 1e-4 against both reference paths."""
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm
    ref_cfg, cfg = _ssm()
    ref_p, p = _both(ref_cfg, cfg, seed=13)
    x = np.random.default_rng(14).normal(size=(2, 24, 64)).astype(
        np.float32)
    lp = transformer.layer_params(p["layers"], 1)["ssm"]
    ref_lp = jax.tree.map(lambda a: a[1], ref_p["layers"])["ssm"]
    got = ssm.mamba_block(lp, cfg, torch.from_numpy(x), Runtime())
    for impl in ("pallas", "xla"):
        want = ref_ssm.mamba_block(ref_lp, ref_cfg, jnp.asarray(x),
                                   impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SSM_TOL, atol=SSM_TOL)


def test_mamba2_config_and_specs_match_the_reference():
    want = ref_registry.get("mamba2-2.7b").cfg
    got = registry.get("mamba2-2.7b").cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    ref_specs = jax.tree_util.tree_flatten_with_path(
        ref_registry.param_specs(_ssm()[0]),
        is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))[0]
    specs = list(layers.spec_leaves(registry.param_specs(_ssm()[1])))
    assert len(specs) == len(ref_specs)
    for (_, w), g in zip(ref_specs, specs):
        assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init)
        assert str(g.dtype).split(".")[-1] == str(np.dtype(w.dtype))


def test_convert_keeps_float32_specs():
    """Asked for bfloat16, the ssm's a_log / dt_bias / d_skip stay
    float32 (as the reference keeps them); everything else is cast."""
    ref_cfg, cfg = _ssm()
    got = convert.params_from_numpy(_ref_params(ref_cfg, 15), cfg, "cpu",
                                    torch.bfloat16)
    ssm_p = got["layers"]["ssm"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert ssm_p[k].dtype == torch.float32
    for k in ("w_in", "conv_w", "conv_b", "norm", "w_out"):
        assert ssm_p[k].dtype == torch.bfloat16
    assert got["embed"].dtype == torch.bfloat16
    params = registry.Arch(cfg).init_params(0, "cpu", torch.bfloat16)
    assert params["layers"]["ssm"]["a_log"].dtype == torch.float32
    assert params["lm_head"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

def test_unported_families_and_entry_points_raise():
    """The ssm family serves (its decode entry points work); the moe,
    vlm and encdec families' entry points run on their reduced configs
    and their training raises naming ROADMAP item 24, a hybrid's naming
    item 22; a family named without its sub-config raises
    ``ValueError``."""
    _, ssm_cfg = _ssm()
    arch = registry.Arch(ssm_cfg)
    assert arch.prefill_fn() is None
    assert arch.decode_fn() is registry._ssm_decode_step
    specs = registry.cache_specs(ssm_cfg, ShapeConfig("x", 8, 2, "decode"))
    assert specs["ssm_state"].shape == (3, 2, 8, 16, 16)
    assert specs["conv_state"].shape == (3, 2, 3, 128 + 2 * 2 * 16)
    step = steps.make_serve_step(arch, Runtime(), "decode")
    p = arch.init_params(0, "cpu", torch.float32)
    cache = layers.map_specs(
        lambda sp: torch.zeros(sp.shape, dtype=torch.float32), specs)
    logits, same = step(p, cache, {"tokens": torch.zeros((2, 1),
                                                         dtype=torch.int32)},
                        torch.zeros(2, dtype=torch.int32))
    assert logits.shape == (2, ssm_cfg.vocab_size) and same is cache
    assert cache["ssm_state"].abs().sum() > 0
    hybrid_arch = registry.get("zamba2-2.7b")
    with pytest.raises(NotImplementedError, match="item 22"):
        steps.make_train_step(hybrid_arch, Runtime())
    with pytest.raises(NotImplementedError, match="item 22"):
        api.Trainer("zamba2-2.7b", hybrid_arch.cfg.reduced(),
                    api.TrainConfig(steps=1), device="cpu")
    for name in ("qwen2-moe-a2.7b", "internvl2-26b", "seamless-m4t-medium"):
        arch = registry.get(name)
        small = registry.Arch(arch.cfg.reduced())
        p = small.init_params(0, "cpu", torch.float32)
        specs = small.input_specs(ShapeConfig("x", 24, 2, "train"))
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in specs.items()}
        assert small.loss_fn()(p, small.cfg, batch, Runtime()).dim() == 0
        assert steps.make_serve_step(small, Runtime(), "prefill")(p, batch)
        cache = layers.map_specs(lambda sp: torch.zeros(sp.shape),
                                 small.cache_specs(ShapeConfig("x", 8, 2,
                                                               "decode")))
        logits, same = steps.make_serve_step(small, Runtime(), "decode")(
            p, cache, {"tokens": torch.zeros((2, 1), dtype=torch.int32)},
            torch.zeros(2, dtype=torch.int32))
        assert logits.shape == (2, small.cfg.vocab_size) and same is cache
        with pytest.raises(NotImplementedError, match="item 24"):
            steps.make_train_step(arch, Runtime())
    for family in ("moe", "encdec", "vlm"):
        other = registry.Arch(dataclasses.replace(_dense("fan")[1],
                                                  family=family))
        for entry in (other.loss_fn, other.prefill_fn, other.decode_fn,
                      other.param_specs):
            with pytest.raises(ValueError, match=f"cfg.{family}"):
                entry()
    # training is ported (slice 4): make_train_step builds a step
    assert callable(steps.make_train_step(registry.get("qwen3-1.7b"),
                                          Runtime()))
    with pytest.raises(KeyError):
        steps.make_serve_step(registry.get("qwen3-1.7b"), Runtime(), "x")


@pytest.mark.usefixtures("f32_reference")
def test_forward_refuses_parameters_that_need_a_gradient():
    """Parameters that need a gradient get one through every kernel site:
    the loss's gradient with respect to the stacked ``wq``, the norms and
    the embedding against ``jax.grad`` of the reference's ``lm_loss``
    (XLA path), float32, 2e-5 of each leaf's largest entry; under
    ``no_grad`` the loss is the same value."""
    ref_cfg, cfg = _dense("fan")
    ref_p, p = _both(ref_cfg, cfg, seed=16)
    tokens = _tokens(cfg, 1, 8, seed=17)
    keys = (("layers", "attn", "wq"), ("layers", "attn_norm", "scale"),
            ("layers", "ffn_norm", "scale"), ("final_norm", "scale"),
            ("embed",))

    def leaf(tree, key):
        for k in key:
            tree = tree[k]
        return tree

    for key in keys:
        leaf(p, key).requires_grad_()
    batch = {"tokens": torch.from_numpy(tokens)}
    loss = registry.Arch(cfg).loss_fn()(p, cfg, batch, Runtime())
    grads = torch.autograd.grad(loss, [leaf(p, k) for k in keys])
    want = jax.grad(lambda q: ref_transformer.lm_loss(
        q, ref_cfg, {"tokens": jnp.asarray(tokens)}, RefRuntime()))(ref_p)
    for key, g in zip(keys, grads):
        w = np.asarray(leaf(want, key))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max())
    with torch.no_grad():
        again = registry.Arch(cfg).loss_fn()(p, cfg, batch, Runtime())
    assert float(again) == float(loss.detach())


def test_api_exports_the_forward_entry_points():
    arch = api.get_arch("mamba2-2.7b")
    assert isinstance(arch, api.Arch) and arch.cfg.family == "ssm"
    assert api.make_serve_step is steps.make_serve_step
    assert api.Runtime is Runtime
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_arch("qwen3-1.7b").init_params(0)
