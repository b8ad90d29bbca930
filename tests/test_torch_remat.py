"""Rematerialisation (``Runtime.remat`` none | full | dots) through every
family's layer walk, in float32 on the CPU.

The configs are the reference's ``reduced()`` presets of six families:
qwen3-1.7b (dense), mamba2-2.7b (ssm), zamba2-2.7b (hybrid, the shared
block every 2 of 4 layers), qwen2-moe-a2.7b (moe), internvl2-26b (vlm)
and seamless-m4t-medium (encdec, 2 + 2 layers), with the parameters and
batches of ``test_torch_train_families.py`` (the reference's
initialisation in float32, seeded numpy batches of 2 x 32).

* ``full`` and ``dots`` give the loss and every gradient leaf bit for bit
  as ``none`` does: the rerun computes the same values and the autograd
  graph is the same one.
* Each policy's gradients are within 2e-5 of each leaf's largest |g| of
  ``jax.grad`` of the reference's loss under ``RefRuntime(remat=<the
  same policy>)``.
* A counting ``Runtime`` pins each kernel site's calls a step: under
  ``full`` and ``dots`` every site inside a region runs twice (the rerun
  stops after the region's last saved tensor, which every region's
  trailing product holds) and the sites outside the regions once (each
  stack's final norm, the vlm projector's norm).  ``chip_smoke.py``
  holds the card's launches to the same rule.
* A site whose "kernel" is its plain version behind
  ``kernels/autograd.kernel_with_plain_grad`` (as every wrapper on the
  card) reruns under the recompute and still gives the same gradients.
* Prefill and decode run without grad, where ``Runtime.checkpoint`` is
  the identity: their outputs are the same under every policy.
* ``runtime.recomputing()`` tells an observer of a layer body a rerun
  from the step's own call, so a router probe counts a step once.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.runtime import Runtime as RefRuntime
from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import kernel_with_plain_grad
from repro_torch.models import layers, moe, registry, runtime
from repro_torch.models.config import ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import steps
from test_torch_train_families import (SEEDS, _batch, _check_grads,
                                       _configs, _jax_batch, _params, _rel,
                                       _torch_batch)

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("qwen3-1.7b", "mamba2-2.7b", "zamba2-2.7b", "qwen2-moe-a2.7b",
            "internvl2-26b", "seamless-m4t-medium")
POLICIES = ("none", "full", "dots")
# (token seed, parameter seed): the MoE's and the others' of
# test_torch_train_families (every router gap over 1e-5), the dense and
# ssm configs' own
FAMILY_SEEDS = {"qwen3-1.7b": (600, 40), "mamba2-2.7b": (601, 41), **SEEDS}
LOSS_RTOL = 1e-5

# each site's calls in one loss forward and backward under "none"
CALLS_NONE = {
    "qwen3-1.7b": {"rms_norm": 5, "rms_norm_residual": 4,
                   "flash_attention": 2},
    "mamba2-2.7b": {"rms_norm": 3, "rms_norm_residual": 2, "ssd_scan": 2},
    "zamba2-2.7b": {"rms_norm": 5, "rms_norm_residual": 8, "ssd_scan": 4,
                    "flash_attention": 2},
    "qwen2-moe-a2.7b": {"rms_norm": 1, "rms_norm_residual": 4,
                        "flash_attention": 2},
    "internvl2-26b": {"rms_norm": 2, "rms_norm_residual": 4,
                      "flash_attention": 2},
    "seamless-m4t-medium": {"rms_norm": 2, "rms_norm_residual": 10,
                            "flash_attention": 4},
}
# ... and under "full" and "dots"
CALLS_REMAT = {
    "qwen3-1.7b": {"rms_norm": 10, "rms_norm_residual": 7,
                   "flash_attention": 4},
    "mamba2-2.7b": {"rms_norm": 6, "rms_norm_residual": 3, "ssd_scan": 4},
    "zamba2-2.7b": {"rms_norm": 10, "rms_norm_residual": 15, "ssd_scan": 8,
                    "flash_attention": 4},
    "qwen2-moe-a2.7b": {"rms_norm": 2, "rms_norm_residual": 7,
                        "flash_attention": 4},
    "internvl2-26b": {"rms_norm": 3, "rms_norm_residual": 7,
                      "flash_attention": 4},
    "seamless-m4t-medium": {"rms_norm": 4, "rms_norm_residual": 18,
                            "flash_attention": 8},
}
# the sites outside every region: each stack's final norm, the vlm
# projector's norm
OUTSIDE = {"dense": {"rms_norm_residual": 1}, "ssm": {"rms_norm_residual": 1},
           "hybrid": {"rms_norm_residual": 1},
           "moe": {"rms_norm_residual": 1},
           "vlm": {"rms_norm": 1, "rms_norm_residual": 1},
           "encdec": {"rms_norm_residual": 2}}


@pytest.fixture(autouse=True)
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


@dataclasses.dataclass(frozen=True)
class CountingRuntime(Runtime):
    """Counts every kernel site call in :data:`CALLS`."""

    def op(self, name):
        fn = super().op(name)

        def site(*args, **kwargs):
            CALLS[name] += 1
            return fn(*args, **kwargs)
        return site


@dataclasses.dataclass(frozen=True)
class PlainAsKernelRuntime(Runtime):
    """Every site through ``kernel_with_plain_grad`` with its plain
    version as the "kernel" (as a wrapper on the card does with its
    CUDA kernel); the "kernel" counts its calls in :data:`CALLS`."""

    def op(self, name):
        plain = ops.PLAIN[name]

        def site(*args, **kwargs):
            at = [i for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor)]

            def with_tensors(fn):
                def run(*tensors):
                    full = list(args)
                    for i, t in zip(at, tensors):
                        full[i] = t
                    return fn(*full, **kwargs)
                return run

            def kernel(*tensors):
                CALLS[name] += 1
                return with_tensors(plain)(*tensors)

            return kernel_with_plain_grad(kernel, with_tensors(plain),
                                          *(args[i] for i in at))
        return site


CALLS = collections.Counter()


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(ref_cfg, cfg, ref params, params, numpy batch); the tests only
    read them."""
    ref_cfg, cfg = _configs(name)
    tok_seed, p_seed = FAMILY_SEEDS[name]
    ref_p, p = _params(ref_cfg, cfg, p_seed)
    return ref_cfg, cfg, ref_p, p, _batch(cfg, 2, 32, tok_seed)


def _grads(cfg, p, batch, rt):
    """(loss, grads, each site's calls) of one ``value_and_grad``."""
    CALLS.clear()
    loss, grads = steps.value_and_grad(registry.Arch(cfg), rt)(
        p, _torch_batch(batch))
    return loss, grads, dict(CALLS)


def _bit_identical(a, b):
    (loss_a, g_a), (loss_b, g_b) = a, b
    assert torch.equal(loss_a, loss_b), (float(loss_a), float(loss_b))
    for (path, x), y in zip(tree_util.paths(g_a), tree_util.leaves(g_b)):
        assert torch.equal(x, y), (path, float((x - y).abs().max()))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_are_bit_identical_to_none(name, remat):
    _, cfg, _, p, batch = _setup(name)
    loss, grads, _ = _grads(cfg, p, batch, Runtime())
    got, got_grads, _ = _grads(cfg, p, batch, Runtime(remat=remat))
    _bit_identical((got, got_grads), (loss, grads))


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_match_jax_grad_under_the_same_policy(name, remat):
    ref_cfg, cfg, ref_p, p, batch = _setup(name)
    ref_loss = ref_registry.Arch(ref_cfg).loss_fn()
    ref_rt = RefRuntime(remat=remat)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda q, bt: ref_loss(q, ref_cfg, bt, ref_rt)))(
            ref_p, _jax_batch(batch))
    loss, grads, _ = _grads(cfg, p, batch, Runtime(remat=remat))
    assert _rel(loss, want_loss) <= LOSS_RTOL
    _check_grads(grads, want)


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_each_site_runs_a_pinned_number_of_times_a_step(name, remat):
    """The exact calls a step: every site inside a region twice under
    ``full`` and ``dots``, once outside, i.e. 2 x none - OUTSIDE."""
    _, cfg, _, p, batch = _setup(name)
    _, _, calls = _grads(cfg, p, batch, CountingRuntime(remat=remat))
    want = CALLS_NONE[name] if remat == "none" else CALLS_REMAT[name]
    assert calls == want
    outside = OUTSIDE[cfg.family]
    assert CALLS_REMAT[name] == {k: 2 * n - outside.get(k, 0)
                                 for k, n in CALLS_NONE[name].items()}


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["qwen3-1.7b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_the_plain_gradient_wrapper_reruns_under_the_recompute(name, remat):
    """With every site behind ``kernel_with_plain_grad`` (its backward
    the plain version's VJP from its saved inputs), the rerun calls each
    region's "kernels" again and the gradients stay bit-identical to the
    same sites under ``none``."""
    _, cfg, _, p, batch = _setup(name)
    loss, grads, calls = _grads(cfg, p, batch, PlainAsKernelRuntime())
    assert calls == CALLS_NONE[name]
    got, got_grads, calls = _grads(cfg, p, batch,
                                   PlainAsKernelRuntime(remat=remat))
    assert calls == CALLS_REMAT[name]
    _bit_identical((got, got_grads), (loss, grads))


def _serve_inputs(cfg, batch):
    """The prefill batch and a decode step's inputs on a zeroed cache of
    one more position: (prefill batch, cache, tokens, positions)."""
    b, s = batch["tokens"].shape
    cache = layers.map_specs(
        lambda sp: torch.zeros(sp.shape),
        registry.cache_specs(cfg, ShapeConfig("x", s + 1, b, "decode")))
    return (_torch_batch(batch), cache,
            torch.from_numpy(batch["tokens"][:, -1:]),
            torch.full((b,), s, dtype=torch.int32))


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_are_the_same_under_every_policy(name):
    _, cfg, _, p, batch = _setup(name)
    arch = registry.Arch(cfg)
    outs = {}
    with torch.no_grad():
        for remat in POLICIES:
            rt = Runtime(remat=remat)
            pre, cache, tokens, pos = _serve_inputs(cfg, batch)
            first = steps.make_serve_step(arch, rt, "prefill")(p, pre)
            logits, cache = arch.decode_fn()(p, cfg, cache, tokens, pos, rt)
            outs[remat] = tree_util.leaves((first, logits, cache))
    for remat in ("full", "dots"):
        for a, b in zip(outs[remat], outs["none"]):
            assert torch.equal(a, b), remat


def test_checkpoint_is_the_identity_without_grad_or_remat():
    def fn(x):
        return x * 2

    with torch.no_grad():
        for remat in POLICIES:
            assert Runtime(remat=remat).checkpoint(fn) is fn
    assert Runtime().checkpoint(fn) is fn
    assert Runtime(remat="full").checkpoint(fn) is not fn


@pytest.mark.parametrize("bad", ["", "Full", "dot", "selective", None])
def test_an_unknown_remat_policy_raises(bad):
    with pytest.raises(ValueError, match="remat"):
        Runtime(remat=bad)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recomputing_tells_the_rerun_from_the_step(remat, monkeypatch):
    """A region body sees ``recomputing()`` False in the step's own call
    and True in the backward's rerun; a router probe that skips the
    reruns counts one call a MoE layer a step, as under ``none``."""
    seen = []

    def body(x):
        seen.append(runtime.recomputing())
        return (x @ x).sin()

    x = torch.randn(4, 4, requires_grad=True)
    Runtime(remat=remat).checkpoint(body)(x).sum().backward()
    assert seen == [False, True] and not runtime.recomputing()

    _, cfg, _, p, batch = _setup("qwen2-moe-a2.7b")
    route, routed = moe.route, collections.Counter()

    def probe(*args):
        routed["rerun" if runtime.recomputing() else "step"] += 1
        return route(*args)

    monkeypatch.setattr(moe, "route", probe)
    _grads(cfg, p, batch, Runtime(remat=remat))
    assert routed == {"step": cfg.n_layers, "rerun": cfg.n_layers}
