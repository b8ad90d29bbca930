"""The moe, vlm and encdec families of the port against the reference, in
float32 on the CPU.

The configs are the reference's ``reduced()`` presets (d_model 128, 8
experts top-2 with ``d_ff_expert`` 64, vision_dim 64 with 8 patches,
2 + 2 encdec layers).  Parameters are the reference's initialisation,
cast to float32 (the qkv biases drawn at random) and carried across with
``params_from_numpy``; inputs come from seeded numpy generators.  The
reference runs with ``repro.models.layers.DEFAULT_DTYPE`` patched to
float32 and ``Runtime(attn_impl="xla")``.

* moe: ``lm_loss`` (its aux term included) and the hidden states and
  aux of ``forward`` for qwen2-moe-a2.7b and deepseek-moe-16b, and a
  ``decode_step``; every router call's smallest top-k gap is recorded
  and held over 1e-5.  Prefill then decode equals the forward with
  ``capacity_factor = E / K`` (so C >= T and nothing drops).
* vlm: ``project_patches``, ``vlm_loss`` (mask unshifted), ``prefill``
  (logits and cache) and prefill then decode against the forward.
* encdec: ``encode`` at a ragged S = 12 (the non-causal attention's
  mask), ``cross_attention``, ``seq2seq_loss`` and ``decode_step`` over a
  filled cross cache, at one position for every row and at per-row
  positions (each row against the reference's scalar-position step).
* every config: ``input_specs`` equal to the reference's at every
  ``SHAPES`` cell and ``param_specs`` equal at full width.

Tolerances: outputs 2e-5, losses 1e-5 relative, a forward against its
prefill then decode 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.models import attention as ref_attention
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models import vlm as ref_vlm
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.runtime import Runtime as RefRuntime
from repro_torch.models import (attention, convert, encdec, layers, moe,
                                registry, transformer, vlm)
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

ATOL = RTOL = 2e-5
LOSS_RTOL = 1e-5
PATH_TOL = 1e-4
TIE_GAP = 1e-5
MOE = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
RT = Runtime()
REF_RT = RefRuntime(attn_impl="xla")


@pytest.fixture(autouse=True)
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


@pytest.fixture
def router_margins(monkeypatch):
    """Every port router call's smallest gap between a token's K-th and
    (K+1)-th probability."""
    gaps = []
    route = moe.route

    def recording(p, cfg, x):
        probs = torch.softmax(x.to(p["router"].dtype) @ p["router"], -1)
        top = torch.sort(probs, -1, descending=True).values
        k = cfg.moe.top_k
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return route(p, cfg, x)

    monkeypatch.setattr(moe, "route", recording)
    return gaps


def _configs(name, **moe_changes):
    ref_cfg = ref_registry.get(name).cfg.reduced()
    cfg = registry.get(name).cfg.reduced()
    if moe_changes:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_changes))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed):
    """(reference params as jnp float32, the port's float32 tensors)."""
    p = jax.tree.map(lambda x: np.asarray(x, np.float32),
                     ref_layers.init_tree(ref_registry.param_specs(ref_cfg),
                                          jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k in ("bq", "bk", "bv"):
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    draw(p)
    return (jax.tree.map(jnp.asarray, p),
            convert.params_from_numpy(p, cfg, "cpu", torch.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(b, s), dtype=np.int32)


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _loss_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def _zeros(specs):
    return layers.map_specs(lambda s: torch.zeros(s.shape), specs)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_moe_loss_and_forward_match_the_reference(name, router_margins):
    ref_cfg, cfg = _configs(name)
    ref_p, p = _params(ref_cfg, cfg, seed=1)
    tokens = _tokens(cfg, 2, 24, seed=2)
    mask = (np.random.default_rng(3).random((2, 24)) < 0.8).astype(
        np.float32)
    want = jax.jit(lambda q, t, m: ref_transformer.lm_loss(
        q, ref_cfg, {"tokens": t, "mask": m}, REF_RT))(
        ref_p, jnp.asarray(tokens), jnp.asarray(mask))
    got = transformer.lm_loss(p, cfg, {"tokens": torch.from_numpy(tokens),
                                       "mask": torch.from_numpy(mask)}, RT)
    _loss_close(got, want)
    h_r, aux_r = jax.jit(lambda q, t: ref_transformer.forward(
        q, ref_cfg, ref_transformer.embed(q, ref_cfg, t, REF_RT),
        REF_RT))(ref_p, jnp.asarray(tokens))
    h, aux = transformer.forward(p, cfg, transformer.embed(
        p, cfg, torch.from_numpy(tokens)), RT)
    _close(h, h_r)
    assert float(aux_r) > 0
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-6)
    print(f"{name}: smallest router gap {min(router_margins):.3e}")
    assert min(router_margins) > TIE_GAP


@pytest.mark.parametrize("name", MOE)
def test_moe_decode_step_matches_the_reference(name, router_margins):
    """One step at per-row positions over a random cache: logits and the
    written cache at 2e-5."""
    ref_cfg, cfg = _configs(name)
    ref_p, p = _params(ref_cfg, cfg, seed=4)
    b, s_max = 3, 16
    rng = np.random.default_rng(5)
    cache = {k: rng.normal(size=(cfg.n_layers, b, s_max, cfg.n_kv_heads,
                                 cfg.head_dim_)).astype(np.float32)
             for k in ("k", "v")}
    tokens = _tokens(cfg, b, 1, seed=6)
    pos = np.array([3, 9, 15], np.int32)
    want, ref_cache = jax.jit(lambda q, c, t, ps: ref_transformer.decode_step(
        q, ref_cfg, c, t, ps, REF_RT))(
        ref_p, jax.tree.map(jnp.asarray, cache), jnp.asarray(tokens),
        jnp.asarray(pos))
    port_cache = convert.cache_from_numpy(cache, cfg, b, s_max, "cpu",
                                          torch.float32)
    got, same = transformer.decode_step(p, cfg, port_cache,
                                        torch.from_numpy(tokens),
                                        torch.from_numpy(pos), RT)
    assert same is port_cache
    _close(got, want)
    for k in ("k", "v"):
        _close(port_cache[k], ref_cache[k])
    assert min(router_margins) > TIE_GAP


def test_moe_prefill_then_decode_equals_the_forward():
    """With capacity_factor = E / K every expert has C >= T slots, so
    nothing drops and the forward over S tokens equals a prefill of
    S - 1 and one decode step, in float32 at 1e-4."""
    ref_cfg, cfg = _configs("qwen2-moe-a2.7b", capacity_factor=8 / 2)
    for t in (2, 24):
        assert moe._capacity(t, cfg) >= t
    _, p = _params(ref_cfg, cfg, seed=7)
    tokens = torch.from_numpy(_tokens(cfg, 2, 24, seed=8))
    h, _ = transformer.forward(p, cfg, transformer.embed(p, cfg, tokens), RT)
    h = layers.rms_norm(h[:, -1:], p["final_norm"]["scale"], cfg.norm_eps)
    want = transformer.unembed(p, cfg, h)[:, 0]
    cache = _zeros(registry.cache_specs(cfg, ShapeConfig("x", 24, 2,
                                                         "decode")))
    transformer.prefill(p, cfg, tokens[:, :-1], RT, cache)
    got, _ = transformer.decode_step(p, cfg, cache, tokens[:, -1:],
                                     torch.full((2,), 23), RT)
    _close(got, want.detach().numpy(), PATH_TOL)


# ---------------------------------------------------------------------------
# vlm
# ---------------------------------------------------------------------------

def _vlm_batch(cfg, b, s_text, seed):
    rng = np.random.default_rng(seed)
    v = cfg.vlm
    return {"patches": rng.normal(size=(b, v.n_patches, v.vision_dim))
            .astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, size=(b, s_text),
                                   dtype=np.int32),
            "mask": (rng.random((b, s_text)) < 0.8).astype(np.float32)}


def test_vlm_matches_the_reference():
    ref_cfg, cfg = _configs("internvl2-26b")
    ref_p, p = _params(ref_cfg, cfg, seed=9)
    batch = _vlm_batch(cfg, 2, 16, seed=10)
    ref_b = jax.tree.map(jnp.asarray, batch)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(vlm.project_patches(p, cfg, b["patches"], RT),
           jax.jit(lambda q, x: ref_vlm.project_patches(q, ref_cfg, x))(
               ref_p, ref_b["patches"]))
    _loss_close(vlm.vlm_loss(p, cfg, b, RT),
                jax.jit(lambda q, x: ref_vlm.vlm_loss(q, ref_cfg, x,
                                                      REF_RT))(ref_p, ref_b))
    no_mask = {k: v for k, v in batch.items() if k != "mask"}
    want, ref_cache = jax.jit(lambda q, x: ref_vlm.prefill(
        q, ref_cfg, x, REF_RT))(ref_p, jax.tree.map(jnp.asarray, no_mask))
    got, cache = registry.Arch(cfg).prefill_fn()(
        p, {k: torch.from_numpy(v) for k, v in no_mask.items()}, RT)
    _close(got, want)
    for k in ("k", "v"):
        assert cache[k].shape == ref_cache[k].shape
        _close(cache[k], ref_cache[k])


def test_vlm_prefill_then_decode_equals_the_forward():
    ref_cfg, cfg = _configs("internvl2-26b")
    _, p = _params(ref_cfg, cfg, seed=11)
    batch = {k: torch.from_numpy(v)
             for k, v in _vlm_batch(cfg, 2, 12, seed=12).items()
             if k != "mask"}
    n = cfg.vlm.n_patches + 12
    want, _ = vlm.prefill(p, cfg, batch, RT)
    cache = _zeros(registry.cache_specs(cfg, ShapeConfig("x", n, 2,
                                                         "decode")))
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    vlm.prefill(p, cfg, short, RT, cache)
    got, _ = vlm.decode_step(p, cfg, cache, batch["tokens"][:, -1:],
                             torch.full((2,), n - 1), RT)
    _close(got, want.detach().numpy(), PATH_TOL)


# ---------------------------------------------------------------------------
# encdec
# ---------------------------------------------------------------------------

def test_encdec_encode_cross_attention_and_loss_match_the_reference():
    ref_cfg, cfg = _configs("seamless-m4t-medium")
    ref_p, p = _params(ref_cfg, cfg, seed=13)
    rng = np.random.default_rng(14)
    frames = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    memory_r = jax.jit(lambda q, f: ref_encdec.encode(q, ref_cfg, f,
                                                      REF_RT))(
        ref_p, jnp.asarray(frames))
    memory = encdec.encode(p, cfg, torch.from_numpy(frames), RT)
    _close(memory, memory_r)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    lp = transformer.layer_params(p["decoder"], 1)["cross"]
    ref_lp = jax.tree.map(lambda a: a[1], ref_p["decoder"]["cross"])
    xt = torch.from_numpy(x)
    _close(attention.cross_attention(lp, cfg, xt, torch.from_numpy(frames),
                                     encdec._rope(cfg, xt)),
           ref_attention.cross_attention(ref_lp, ref_cfg, jnp.asarray(x),
                                         jnp.asarray(frames)))
    tokens = _tokens(cfg, 2, 11, seed=15)
    mask = (rng.random((2, 11)) < 0.8).astype(np.float32)
    batch = {"frames": frames, "tokens": tokens, "mask": mask}
    _loss_close(
        registry.Arch(cfg).loss_fn()(
            p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, RT),
        jax.jit(lambda q, bb: ref_encdec.seq2seq_loss(q, ref_cfg, bb,
                                                      REF_RT))(
            ref_p, jax.tree.map(jnp.asarray, batch)))
    got, empty = registry.Arch(cfg).prefill_fn()(
        p, {"frames": torch.from_numpy(frames)}, RT)
    assert empty == {}
    _close(got, memory_r)


def test_encdec_decode_step_matches_the_reference():
    """Over a filled cross cache (random) and a random self cache: one
    position for every row against the reference's scalar step, and
    per-row positions against the reference's step row by row."""
    ref_cfg, cfg = _configs("seamless-m4t-medium")
    ref_p, p = _params(ref_cfg, cfg, seed=16)
    b, s_max = 3, 16
    rng = np.random.default_rng(17)
    specs = registry.cache_specs(cfg, ShapeConfig("x", s_max, b, "decode"))
    assert sorted(specs) == ["cross_k", "cross_v", "k", "v"]
    cache = {k: rng.normal(size=s.shape).astype(np.float32)
             for k, s in specs.items()}
    tokens = _tokens(cfg, b, 1, seed=18)
    ref_step = jax.jit(lambda q, c, t, ps: ref_encdec.decode_step(
        q, ref_cfg, c, t, ps, REF_RT))
    for pos in (np.full(b, 6, np.int32), np.array([2, 9, 15], np.int32)):
        port_cache = convert.cache_from_numpy(cache, cfg, b, s_max, "cpu",
                                              torch.float32)
        got, same = encdec.decode_step(p, cfg, port_cache,
                                       torch.from_numpy(tokens),
                                       torch.from_numpy(pos), RT)
        assert same is port_cache
        for r in range(b):
            row = {k: jnp.asarray(v[:, r:r + 1]) for k, v in cache.items()}
            want, ref_cache = ref_step(ref_p, row, jnp.asarray(
                tokens[r:r + 1]), jnp.int32(pos[r]))
            _close(got[r:r + 1], want)
            for k in ("k", "v"):
                _close(port_cache[k][:, r:r + 1], ref_cache[k])
        for k in ("cross_k", "cross_v"):
            np.testing.assert_array_equal(port_cache[k].numpy(), cache[k])


# ---------------------------------------------------------------------------
# every config: the entry points' shapes
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _spec_rows(tree, path=()):
    if hasattr(tree, "shape"):
        return [(path, tuple(tree.shape), _dtype_name(tree.dtype))]
    return [row for k in sorted(tree) for row in
            _spec_rows(tree[k], path + (k,))]


@pytest.mark.parametrize("name", sorted(registry.names()))
def test_input_and_param_specs_equal_the_reference(name, monkeypatch):
    """``input_specs`` at every SHAPES cell (meta tensors) and
    ``param_specs`` at full width: keys, shapes and dtypes equal (the
    reference's own bfloat16 default, not the float32 of the other
    tests)."""
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.bfloat16)
    arch, ref_arch = registry.get(name), ref_registry.get(name)
    assert [s.name for s in SHAPES] == [s.name for s in REF_SHAPES]
    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        got = arch.input_specs(shape)
        assert all(v.device.type == "meta" for v in got.values())
        assert _spec_rows(got) == _spec_rows(ref_arch.input_specs(
            ref_shape)), (name, shape.name)
        got = arch.input_specs(shape, batch_override=3)
        assert all(v.shape[0] == 3 for v in got.values())
    assert _spec_rows(arch.param_specs()) == _spec_rows(
        ref_arch.param_specs())
    assert arch.cfg.param_count() == ref_arch.cfg.param_count()
    assert arch.cfg.active_param_count() == \
        ref_arch.cfg.active_param_count()
    assert arch.cfg.attention_free == ref_arch.cfg.attention_free


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "encdec", "vlm"])
def test_a_family_without_its_sub_config_raises(family):
    cfg = dataclasses.replace(registry.get("qwen3-1.7b").cfg.reduced(),
                              family=family)
    arch = registry.Arch(cfg)
    for entry in (arch.param_specs, arch.loss_fn, arch.decode_fn,
                  lambda: arch.input_specs(SHAPES[0])):
        with pytest.raises(ValueError, match=f"cfg.{family}"):
            entry()
