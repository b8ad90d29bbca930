"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, in float32 on the CPU.

* ``dispatch_tables`` on the 20 seeded cases of
  ``tests/test_moe.py::test_dispatch_tables_capacity_and_validity``
  (capacity ``max(2, T K / E)``, so most cases drop routes): the token,
  weight and valid tables equal to the reference's, exactly.
* ``route`` on 20 seeded (T, E, K) cases: expert indices exactly equal,
  weights and the aux loss within 1e-6.  Each case records the smallest
  gap between a token's K-th and (K+1)-th router probability over its
  tokens and asserts it is over 1e-5, so that no comparison turns on a
  tie.
* ``moe_block`` at 2e-5 with and without shared experts, padded expert
  slots and a capacity that drops routes; first-choice priority; the pad
  experts never route; a route that drops adds exactly 0.
* The dispatch never reads the device from the host: ``moe_block`` and
  a full MoE ``decode_step`` run with ``Tensor.item``, ``Tensor.tolist``
  and ``nonzero`` patched to raise (the fused serve program captures the
  decode step in a CUDA graph, where a host read breaks the capture).

Router and expert weights are the reference's initialisation (``route``'s
routers a seeded numpy draw), cast to float32 and carried across as
numpy; inputs are drawn from seeded numpy generators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.models import layers, moe, registry, transformer
from repro_torch.models.config import ModelConfig, MoEConfig, ShapeConfig
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

ATOL = RTOL = 2e-5
ROUTE_TOL = 1e-6
TIE_GAP = 1e-5

# the reference's functions, each compiled once a shape (op-by-op
# dispatch compiles every primitive at every new shape)
@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _ref_dispatch_case(t, e, k, cap):
    """``tests/test_moe.py``'s case: (idx, w, the reference's tables)."""
    key = jax.random.key(t * 131 + e)
    idx = jnp.argsort(-jax.random.normal(key, (t, e)), axis=-1)[:, :k]
    w = jax.nn.softmax(jax.random.normal(key, (t, k)), axis=-1)
    return (idx, w) + ref_moe.dispatch_tables(idx, w, e, cap, t)


REF_ROUTE = jax.jit(ref_moe.route, static_argnums=(1,))
REF_BLOCK = jax.jit(ref_moe.moe_block, static_argnums=(1,))


def _cfgs(n_routed=8, top_k=2, n_shared=0, cap=1.25, pad=None, d=32):
    args = dict(name="m", family="moe", n_layers=1, d_model=d, n_heads=2,
                n_kv_heads=2, d_ff=0, vocab_size=64, head_dim=16)
    sub = dict(n_routed=n_routed, top_k=top_k, n_shared=n_shared,
               d_ff_expert=16, capacity_factor=cap, ep_pad_to=pad)
    return (RefModelConfig(**args, moe=RefMoEConfig(**sub)),
            ModelConfig(**args, moe=MoEConfig(**sub)))


def _params(ref_cfg, seed):
    """(reference params as jnp float32, the port's as CPU tensors)."""
    p = jax.tree.map(lambda x: np.asarray(x, np.float32),
                     ref_layers.init_tree(ref_moe.moe_specs(ref_cfg),
                                          jax.random.key(seed)))
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(torch.from_numpy, p))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between a token's K-th and (K+1)-th probability."""
    top = -np.sort(-probs, axis=-1)
    if k >= probs.shape[-1]:
        return float("inf")
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("case", range(20))
def test_dispatch_tables_equal_the_reference(case):
    """``tests/test_moe.py``'s seeded cases: the same idx and weights
    into both, every table equal (int-equal token indices)."""
    rng = np.random.default_rng(31_000 + case)
    t = int(rng.integers(4, 65))
    e = int(rng.integers(2, 9))
    k = min(int(rng.integers(1, 4)), e)
    cap = max(2, t * k // e)
    idx, w, *want = map(np.asarray, _ref_dispatch_case(t, e, k, cap))
    idx_t = torch.from_numpy(idx.astype(np.int64))
    w_t = torch.from_numpy(np.array(w))
    got = moe.dispatch_tables(idx_t, w_t, e, cap, t)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(_np(g), wnt)
    # the slot map reads each kept route's slot, a dropped one the zero row
    slot = _np(moe._dispatch(idx_t, w_t, e, cap, t)[3])
    kept = slot < e * cap
    assert kept.sum() == want[2].sum()
    tok = want[0].reshape(-1)
    for kk, tt in zip(*np.nonzero(kept)):
        assert tok[slot[kk, tt]] == tt


@pytest.mark.parametrize("case", range(20))
def test_route_equals_the_reference(case):
    # seeds chosen by the printed margin: at base 32_000 every case's gap
    # is over TIE_GAP (at 35_000 two are not: cases 14 and 15)
    rng = np.random.default_rng(32_000 + case)
    t = int(rng.integers(4, 65))
    e = int(rng.integers(2, 17))
    k = min(int(rng.integers(1, 5)), e)
    ref_cfg, cfg = _cfgs(n_routed=e, top_k=k)
    router = (rng.normal(size=(cfg.d_model, e)) / np.sqrt(cfg.d_model)
              ).astype(np.float32)
    ref_p, p = {"router": jnp.asarray(router)}, \
        {"router": torch.from_numpy(router)}
    x = rng.normal(size=(t, cfg.d_model)).astype(np.float32)
    logits = (x @ router).astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    margin = _margin(probs / probs.sum(-1, keepdims=True), k)
    print(f"case {case}: T={t} E={e} K={k} router margin {margin:.3e}")
    assert margin > TIE_GAP, "the seed makes a near tie"
    idx_r, w_r, aux_r = REF_ROUTE(ref_p, ref_cfg, jnp.asarray(x))
    idx, w, aux = moe.route(p, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(idx), np.asarray(idx_r))
    np.testing.assert_allclose(_np(w), np.asarray(w_r), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities rank the lower expert first, as
    ``jax.lax.top_k`` does."""
    ref_cfg, cfg = _cfgs(n_routed=6, top_k=3)
    router = np.zeros((cfg.d_model, 6), np.float32)
    router[:, 4] = router[:, 1] = 1.0              # experts 1, 4 tie first
    x = np.ones((5, cfg.d_model), np.float32)
    idx_r, _, _ = ref_moe.route({"router": jnp.asarray(router)}, ref_cfg,
                                jnp.asarray(x))
    idx, _, _ = moe.route({"router": torch.from_numpy(router)}, cfg,
                          torch.from_numpy(x))
    np.testing.assert_array_equal(_np(idx), np.asarray(idx_r))
    assert _np(idx)[0].tolist() == [1, 4, 0]


def test_first_choice_priority():
    """An oversubscribed expert gives its slots to first choices."""
    t, e, cap = 6, 2, 3
    idx = torch.tensor([[0, 1]] * 3 + [[1, 0]] * 3)
    tok, _, valid = moe.dispatch_tables(idx, torch.full((t, 2), 0.5), e,
                                        cap, t)
    assert set(_np(tok)[0][_np(valid)[0]].tolist()) == {0, 1, 2}
    assert set(_np(tok)[1][_np(valid)[1]].tolist()) == {3, 4, 5}


MOE_CASES = {
    # (n_routed, top_k, n_shared, capacity_factor, ep_pad_to)
    "routed": (8, 2, 0, 1.25, None),
    "shared": (8, 2, 2, 1.25, None),
    "padded": (6, 3, 1, 1.25, 8),
    "drops": (4, 2, 0, 0.25, None),
}


@pytest.mark.parametrize("key", sorted(MOE_CASES))
def test_moe_block_equals_the_reference(key):
    n, k, sh, cf, pad = MOE_CASES[key]
    ref_cfg, cfg = _cfgs(n_routed=n, top_k=k, n_shared=sh, cap=cf, pad=pad)
    ref_p, p = _params(ref_cfg, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    y_r, aux_r = REF_BLOCK(ref_p, ref_cfg, jnp.asarray(x))
    y, aux = moe.moe_block(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), np.asarray(y_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    idx, w, _ = moe.route(p, cfg, torch.from_numpy(x.reshape(-1,
                                                             cfg.d_model)))
    e_pad = moe._padded_experts(cfg)
    _, _, valid = moe.dispatch_tables(idx, w, e_pad,
                                      moe._capacity(48, cfg), 48)
    dropped = 48 * k - int(_np(valid).sum())
    assert key != "drops" or dropped > 0


def test_pad_experts_never_route():
    """qwen2-moe-a2.7b's layout (60 routed experts in 64 slots): the
    router has 60 columns and the pad slots' tables are all invalid."""
    cfg = registry.get("qwen2-moe-a2.7b").cfg
    assert (cfg.moe.n_routed, moe._padded_experts(cfg)) == (60, 64)
    specs = moe.moe_specs(cfg)
    assert specs["router"].shape == (cfg.d_model, 60)
    assert specs["router"].dtype == torch.float32
    assert specs["w_gate"].shape[0] == 64
    _, small = _cfgs(n_routed=6, top_k=3, pad=8)
    _, p = _params(_cfgs(n_routed=6, top_k=3, pad=8)[0], seed=5)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(40, small.d_model)).astype(np.float32))
    idx, w, _ = moe.route(p, small, x)
    assert int(idx.max()) < 6
    _, wt, valid = moe.dispatch_tables(idx, w, 8, moe._capacity(40, small),
                                       40)
    assert not valid[6:].any() and not wt[6:].any()


def test_dropped_routes_add_exactly_zero():
    """With one slot an expert too few, a token whose every route drops
    gets exactly 0 from the routed experts."""
    _, cfg = _cfgs(n_routed=2, top_k=1, cap=0.05)
    _, p = _params(_cfgs(n_routed=2, top_k=1, cap=0.05)[0], seed=7)
    t = 40
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, t, cfg.d_model)).astype(np.float32))
    y, _ = moe.moe_block(p, cfg, x)
    idx, w, _ = moe.route(p, cfg, x[0])
    cap = moe._capacity(t, cfg)
    tok, _, valid = moe.dispatch_tables(idx, w, 2, cap, t)
    kept = set(_np(tok)[_np(valid)].tolist())
    dropped = sorted(set(range(t)) - kept)
    assert cap == 8 and len(dropped) >= t - 2 * cap
    assert dropped and (_np(y)[0, dropped] == 0).all()
    assert (np.abs(_np(y)[0, sorted(kept)]).sum(-1) > 0).all()


@pytest.fixture
def no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a host read of a device value")
    for owner, name in ((torch.Tensor, "item"), (torch.Tensor, "tolist"),
                        (torch.Tensor, "nonzero"), (torch, "nonzero")):
        monkeypatch.setattr(owner, name, refuse)


def test_dispatch_never_reads_the_host(no_host_reads):
    """``moe_block`` and a reduced MoE config's ``decode_step`` (with a
    device valid mask, as the fused serve program runs it) make no host
    read."""
    with pytest.raises(AssertionError, match="host read"):
        torch.zeros(1).item()
    cfg = registry.get("qwen2-moe-a2.7b").cfg.reduced()
    arch = registry.Arch(cfg)
    params = arch.init_params(0, "cpu", torch.float32)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = moe.moe_block(layers_moe(params), cfg, x)
    assert y.shape == x.shape and aux.dim() == 0
    cache = layers.map_specs(lambda s: torch.zeros(s.shape),
                             arch.cache_specs(ShapeConfig("d", 8, 3,
                                                          "decode")))
    logits, same = transformer.decode_step(
        params, cfg, cache, torch.zeros((3, 1), dtype=torch.int32),
        torch.tensor([0, 3, 5], dtype=torch.int32), Runtime(),
        torch.tensor([True, False, True]))
    assert logits.shape == (3, cfg.vocab_size) and same is cache


def layers_moe(params):
    """Layer 0's MoE parameters."""
    return transformer.layer_params(params["layers"], 0)["moe"]
