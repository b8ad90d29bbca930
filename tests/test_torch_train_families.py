"""Training the hybrid, moe, vlm and encdec families: the port against
the reference, in float32 on the CPU.

The configs are the reference's ``reduced()`` presets: zamba2-2.7b at 4
layers with its shared block every 2, qwen2-moe-a2.7b and
deepseek-moe-16b at 2 layers of 8 experts top-2, internvl2-26b with 8
patches of width 64, seamless-m4t-medium at 2 + 2 layers.  Parameters
are the reference's initialisation cast to float32 (the qkv biases and
the ssm's per-head vectors drawn at random) and carried across with
``params_from_numpy``; batches come from seeded numpy generators.  The
reference runs with ``repro.models.layers.DEFAULT_DTYPE`` patched to
float32 and its XLA path.

* ``steps.value_and_grad`` of every family against ``jax.grad`` of the
  reference's loss: each leaf within 2e-5 of its largest |g|, the loss
  within 1e-5 relative.  The MoE's routing is discontinuous, so every
  router call of the port records its smallest gap between a token's
  K-th and (K+1)-th probability, and the test holds it over 1e-5 (its
  seed is chosen so); the dispatch drops routes at these shapes, and a
  dropped route's weight gets exactly zero gradient.
* The router fault: an update casts the float32 router to bf16 (in both
  packages), and the reference then computes ``x.astype(float32) @
  router`` as a float32 product; the port's ``route`` must too.
* ``make_train_step`` against the reference's step (``_check_step``'s
  bars) for gspmd at W = 1 and the Spindle reductions at W = 2, whose
  workers each route their own (B/W) S tokens, as inside the
  reference's ``shard_map``.
* A 3-step ``Trainer`` against the reference's ``Trainer`` for a moe
  and an encdec config (the stub frontends' batches included), a
  restart on a MoE tree bit-identical to an unbroken run, the bucket
  plans of the full-width trees equal to the reference's, and
  checkpoints of the mixed-dtype trees across the two packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.core import gradsync as ref_gradsync
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.models.runtime import Runtime as RefRuntime
from repro.optim import adamw as ref_adamw
from repro.train import checkpoint as ref_checkpoint
from repro.train import steps as ref_steps
from repro.train import trainer as ref_trainer
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.core import gradsync
from repro_torch.models import convert, layers, moe, registry
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, steps
from test_torch_train import _check_step, _close_tree, _rel, _ref_spindle_step

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = 2e-5
LOSS_RTOL = 1e-5
TIE_GAP = 1e-5
FAMILIES = ("zamba2-2.7b", "qwen2-moe-a2.7b", "deepseek-moe-16b",
            "internvl2-26b", "seamless-m4t-medium")
DRAWS = {"bq": (0, 0.1), "bk": (0, 0.1), "bv": (0, 0.1),
         "conv_b": (0, 0.1), "a_log": (0, 0.5), "dt_bias": (0, 0.5),
         "d_skip": (1, 0.3)}
S_SRC = 12          # the encdec's frames: a ragged non-causal length


@pytest.fixture(autouse=True)
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


@pytest.fixture
def router_gaps(monkeypatch):
    """Every port router call's smallest gap between a token's K-th and
    (K+1)-th probability, and every dispatch's dropped routes."""
    seen = {"gaps": [], "dropped": 0, "router_dtypes": set(),
            "weight_dtypes": set()}
    route, dispatch = moe.route, moe._dispatch

    def recording_route(p, cfg, x):
        with torch.no_grad():
            probs = torch.softmax(moe.router_logits(p, x), -1)
        top = torch.sort(probs, -1, descending=True).values
        k = cfg.moe.top_k
        seen["gaps"].append(float((top[:, k - 1] - top[:, k]).min()))
        out = route(p, cfg, x)
        seen["router_dtypes"].add(p["router"].dtype)
        seen["weight_dtypes"].add(out[1].dtype)
        return out

    def recording_dispatch(idx, weights, e, c, t):
        out = dispatch(idx, weights, e, c, t)
        seen["dropped"] += int(idx.numel() - out[2].sum())
        return out

    monkeypatch.setattr(moe, "route", recording_route)
    monkeypatch.setattr(moe, "_dispatch", recording_dispatch)
    return seen


def _configs(name):
    return (ref_registry.get(name).cfg.reduced(),
            registry.get(name).cfg.reduced())


def _host_params(ref_cfg, seed):
    """The reference's initialisation as float32 numpy, the biases and
    the ssm's per-head vectors drawn (a zero or one init hides bugs)."""
    p = jax.tree.map(lambda x: np.asarray(x, np.float32),
                     ref_layers.init_tree(ref_registry.param_specs(ref_cfg),
                                          jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k in DRAWS:
                mu, sd = DRAWS[k]
                tree[k] = rng.normal(mu, sd, v.shape).astype(np.float32)

    draw(p)
    return p


def _params(ref_cfg, cfg, seed):
    host = _host_params(ref_cfg, seed)
    return (jax.tree.map(jnp.asarray, host),
            convert.params_from_numpy(host, cfg, "cpu", torch.float32))


def _batch(cfg, b, s, seed):
    """A numpy batch of the family's inputs: tokens, and the vlm's
    patches or the encdec's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.vlm.n_patches,
                                          cfg.vlm.vision_dim)
                                    ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, S_SRC, cfg.d_model)
                                   ).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check_grads(got, want_jax, tol=GRAD_TOL):
    """Each leaf within ``tol`` of the reference leaf's largest |g|."""
    want = jax.tree.leaves(want_jax)
    assert len(want) == len(tree_util.leaves(got))
    for (path, g), w in zip(tree_util.paths(got), want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        top = float(np.abs(w).max()) or 1.0
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= tol * top, (path, err, top)


# ---------------------------------------------------------------------------
# the router fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_route_on_a_bf16_router_is_a_float32_product(seed):
    """After one update the router is bf16 in both packages; the
    reference's ``x.astype(float32) @ router`` promotes the product to
    float32, and the port's ``route`` must give its routes, weights (in
    float32) and aux term on the same arrays."""
    ref_cfg, cfg = _configs("qwen2-moe-a2.7b")
    rng = np.random.default_rng(400 + seed)
    d, e = cfg.d_model, cfg.moe.n_routed
    router = jnp.asarray(rng.normal(0, d ** -0.5, (d, e)), jnp.bfloat16)
    x = rng.normal(size=(48, d)).astype(np.float32)
    idx, w, aux = ref_moe.route({"router": router}, ref_cfg, jnp.asarray(x))
    host = np.asarray(router.astype(jnp.float32))
    p = {"router": torch.from_numpy(host).to(torch.bfloat16)}
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, -1))
    top = -np.sort(-probs, -1)
    assert (top[:, 1] - top[:, 2]).min() > TIE_GAP
    got_idx, got_w, got_aux = moe.route(p, cfg, torch.from_numpy(x))
    assert got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), rtol=0,
                               atol=1e-6)
    assert _rel(got_aux, aux) <= 1e-6


def test_dropped_routes_get_zero_gradient():
    """The dispatch's scatter sends every dropped route to one extra
    cell that is sliced away: a dropped route's weight gets exactly 0,
    a kept one the gradient of its slot, as ``jax.grad`` through the
    reference's ``mode="drop"`` scatter gives."""
    t, e, k, cap = 40, 4, 2, 12
    rng = np.random.default_rng(410)
    idx = np.argsort(-rng.normal(size=(t, e)), -1)[:, :k]
    w = rng.uniform(0.1, 1, (t, k)).astype(np.float32)
    cot = rng.normal(size=(e, cap)).astype(np.float32)

    def ref_fn(weights):
        return (ref_moe.dispatch_tables(jnp.asarray(idx), weights, e, cap,
                                        t)[1] * cot).sum()

    want = np.asarray(jax.grad(ref_fn)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    _, table, valid, slot = moe._dispatch(torch.from_numpy(idx), wt, e, cap,
                                          t)
    (table * torch.from_numpy(cot)).sum().backward()
    dropped = (slot == e * cap).T.numpy()
    assert dropped.any() and not dropped.all()
    assert (wt.grad.numpy()[dropped] == 0).all()
    np.testing.assert_array_equal(wt.grad.numpy(), want)


# ---------------------------------------------------------------------------
# the loss gradients
# ---------------------------------------------------------------------------

# (token seed, parameter seed) of each config; the MoE's chosen so that
# every router gap is over TIE_GAP
SEEDS = {name: (500 + i, 20 + i) for i, name in enumerate(FAMILIES)}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_gradient_matches_jax_grad(name, router_gaps):
    """``value_and_grad`` of the family's loss (the MoE's aux term, the
    hybrid's shared block at every site, the vlm's projector, the
    encdec's non-causal encoder and cross attention) against
    ``jax.grad`` of the reference's."""
    ref_cfg, cfg = _configs(name)
    tok_seed, p_seed = SEEDS[name]
    ref_p, p = _params(ref_cfg, cfg, p_seed)
    batch = _batch(cfg, 2, 32, tok_seed)
    ref_loss = ref_registry.Arch(ref_cfg).loss_fn()
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda q, bt: ref_loss(q, ref_cfg, bt, RefRuntime())))(
            ref_p, _jax_batch(batch))
    loss, grads = steps.value_and_grad(registry.Arch(cfg), Runtime())(
        p, _torch_batch(batch))
    assert _rel(loss, want_loss) <= LOSS_RTOL
    _check_grads(grads, want)
    if cfg.moe is not None:
        assert len(router_gaps["gaps"]) == cfg.n_layers
        assert min(router_gaps["gaps"]) > TIE_GAP, router_gaps["gaps"]
        assert router_gaps["dropped"] > 0     # the drop's gradient is held
    if cfg.hybrid is not None:
        shared = tree_util.leaves(grads["shared_block"])
        assert all(bool(g.abs().max() > 0) for g in shared)


def test_hybrid_shared_block_gradient_sums_its_sites():
    """zamba2's shared attention block runs at every ``attn_every``-th
    layer: its gradient is the sum over those sites, so a block cut to
    one site gets a different one."""
    ref_cfg, cfg = _configs("zamba2-2.7b")
    _, p = _params(ref_cfg, cfg, 30)
    batch = _torch_batch(_batch(cfg, 1, 32, 31))
    vg = steps.value_and_grad(registry.Arch(cfg), Runtime())
    _, both = vg(p, batch)
    one = dataclasses.replace(cfg, n_layers=2)
    p_one = dict(p, mamba_layers=tree_util.map(lambda t: t[:1],
                                               p["mamba_layers"]))
    _, first = steps.value_and_grad(registry.Arch(one), Runtime())(p_one,
                                                                   batch)
    for a, b in zip(tree_util.leaves(both["shared_block"]),
                    tree_util.leaves(first["shared_block"])):
        assert not torch.allclose(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_CASES = [
    ("zamba2-2.7b", "gspmd", 1), ("seamless-m4t-medium", "gspmd", 1),
    ("qwen2-moe-a2.7b", "spindle", 2), ("seamless-m4t-medium", "spindle", 2),
    ("deepseek-moe-16b", "spindle_compressed", 2),
    ("internvl2-26b", "spindle_compressed", 2)]


@pytest.mark.parametrize("name,mode,workers", STEP_CASES)
def test_train_step_matches_the_reference(name, mode, workers, router_gaps):
    """One ``make_train_step`` against the reference's: at W = 1 its
    step on the one-device smoke mesh, at W = 2 its ``_manual_grads``
    reduction, every batch leaf (tokens, patches, frames) split by rows
    between the workers."""
    ref_cfg, cfg = _configs(name)
    tok_seed, p_seed = SEEDS[name]
    ref_p, p = _params(ref_cfg, cfg, p_seed)
    batch = _batch(cfg, 4, 32, tok_seed + 100 * workers)
    step = steps.make_train_step(registry.Arch(cfg), Runtime(
        gradsync=mode, dp_workers=workers))
    if workers == 1:
        want = jax.jit(ref_steps.make_train_step(
            ref_registry.Arch(ref_cfg),
            RefRuntime(mesh=make_smoke_mesh(), gradsync=mode)))(
                ref_p, ref_adamw.init(ref_p), _jax_batch(batch))
    else:
        want = _ref_spindle_step(ref_registry.Arch(ref_cfg), mode, workers,
                                 steps.BUCKET_BYTES, ref_adamw.OptConfig())(
            ref_p, ref_adamw.init(ref_p), _jax_batch(batch))
    got = step(p, adamw.init(p), _torch_batch(batch))
    _check_step(got, want)
    if cfg.moe is not None:
        assert min(router_gaps["gaps"]) > TIE_GAP, router_gaps["gaps"]


def test_each_worker_routes_its_own_tokens(monkeypatch):
    """At W = 2 every MoE layer's capacity comes from the worker's own
    (B/W) S tokens, as inside the reference's ``shard_map``, and each
    worker's gradient is that of its rows alone."""
    _, cfg = _configs("qwen2-moe-a2.7b")
    p = registry.Arch(cfg).init_params(40, "cpu", torch.float32)
    batch = _torch_batch(_batch(cfg, 4, 16, 41))
    seen = []
    capacity = moe._capacity
    monkeypatch.setattr(moe, "_capacity",
                        lambda n, c: seen.append(n) or capacity(n, c))
    arch = registry.Arch(cfg)
    losses, stacked = steps.worker_grads(
        arch, Runtime(gradsync="spindle", dp_workers=2))(p, batch)
    assert seen == [2 * 16] * (2 * cfg.n_layers)
    vg = steps.value_and_grad(arch, Runtime())
    for w in range(2):
        loss, grads = vg(p, {k: v[2 * w:2 * w + 2] for k, v in
                             batch.items()})
        assert torch.equal(losses[w], loss)
        assert all(torch.equal(a[w], b) for a, b in zip(
            tree_util.leaves(stacked), tree_util.leaves(grads)))


def test_worker_grads_split_frames_and_patches_with_the_tokens():
    for name in ("internvl2-26b", "seamless-m4t-medium"):
        _, cfg = _configs(name)
        p = registry.Arch(cfg).init_params(42, "cpu", torch.float32)
        batch = _torch_batch(_batch(cfg, 4, 16, 43))
        arch = registry.Arch(cfg)
        losses, _ = steps.worker_grads(
            arch, Runtime(gradsync="spindle", dp_workers=2))(p, batch)
        loss_fn = arch.loss_fn()
        for w in range(2):
            part = {k: v[2 * w:2 * w + 2] for k, v in batch.items()}
            assert torch.equal(losses[w].float(),
                               loss_fn(p, cfg, part, Runtime()).detach())


# ---------------------------------------------------------------------------
# the Trainer, restart, plans, checkpoints
# ---------------------------------------------------------------------------

def _register(name, ref_cfg, cfg):
    ref_registry.register(name, lambda: ref_cfg)
    registry.register(name, lambda: cfg)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_trainer_matches_the_reference_trainer(name, router_gaps):
    """Three steps of ``Trainer.run`` from the same float32 weights on the
    same token stream (the encdec's frames and targets cut from it by the
    stub frontend, in both).  Both cast the parameters to bf16 after
    every step, the MoE's router included, so steps 2 and 3 run on bf16
    weights: the losses, gradient norms and learning rates within 1e-5
    relative at step 1 and 2e-2 (the bf16 bar of
    ``tests/test_torch_train.py``'s Trainer test) after, and the float32
    masters after step 3 within 2 (lr_1 + lr_2 + lr_3) + 1e-6 (an early
    AdamW step is near a sign step: a gradient near zero may flip its
    move, as ``chip_smoke.py``'s first-step bar allows)."""
    ref_cfg, cfg = _configs(name)
    tag = f"train-families-{name}"
    _register(tag, ref_cfg, cfg)
    ref_p, p = _params(ref_cfg, cfg, 50)
    kw = dict(steps=3, seq_len=32, global_batch=4, log_every=1,
              data_patterns=8)
    ref_tr = ref_trainer.Trainer(tag, ref_cfg, ref_trainer.TrainConfig(**kw),
                                 RefRuntime())
    ref_b = ref_tr._batch_for(0)
    ref_state = ref_tr.run(ref_p, ref_adamw.init(jax.tree.map(jnp.copy,
                                                              ref_p)))
    tr = api.Trainer(tag, cfg, api.TrainConfig(**kw), Runtime(),
                     device="cpu")
    got_b = tr._batch_for(0)
    assert sorted(got_b) == sorted(ref_b)
    for k, v in got_b.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(ref_b[k], np.float32))
    new_p, new_o = tr.run(p, adamw.init(p))
    assert [h["step"] for h in tr.history] == [1, 2, 3]
    for i, (h, r) in enumerate(zip(tr.history, ref_tr.history)):
        tol = 1e-5 if i == 0 else 2e-2
        for k in ("loss", "grad_norm", "lr"):
            assert _rel(h[k], r[k]) <= tol, (i, k, h[k], r[k])
    moved = 2 * sum(h["lr"] for h in tr.history) + 1e-6
    _close_tree(new_o["master"], ref_state[1]["master"], moved)
    if cfg.moe is not None:
        # steps 2 and 3 route through a bf16 router, in float32 as the
        # reference's promoted product
        assert new_p["layers"]["moe"]["router"].dtype == torch.bfloat16
        assert router_gaps["router_dtypes"] == {torch.float32,
                                                torch.bfloat16}
        assert router_gaps["weight_dtypes"] == {torch.float32}
        assert min(router_gaps["gaps"]) > TIE_GAP, router_gaps["gaps"]


def test_moe_trainer_restarts_bit_identically(tmp_path):
    """Save at step 2 and stop; a fresh Trainer restores the mixed-dtype
    tree (bf16 weights, the router among them) and runs step 3:
    parameters, optimizer state and losses equal the unbroken run's, bit
    for bit (W = 2, compressed reduction)."""
    _, cfg = _configs("qwen2-moe-a2.7b")
    rt = Runtime(gradsync="spindle_compressed", dp_workers=2)
    kw = dict(seq_len=32, global_batch=4, log_every=1, data_patterns=8,
              checkpoint_every=2)
    full = api.Trainer("qwen2-moe-a2.7b", cfg, api.TrainConfig(steps=3, **kw),
                       rt, device="cpu")
    p0, o0 = full.init_state(60)
    assert p0["layers"]["moe"]["router"].dtype == torch.float32
    p_full, o_full = full.run(tree_util.map(torch.clone, p0),
                              adamw.init(p0))
    d = str(tmp_path / "ckpt")
    api.Trainer("qwen2-moe-a2.7b", cfg,
                api.TrainConfig(steps=2, checkpoint_dir=d, **kw), rt,
                device="cpu").run(tree_util.map(torch.clone, p0),
                                  adamw.init(p0))
    second = api.Trainer("qwen2-moe-a2.7b", cfg,
                         api.TrainConfig(steps=3, checkpoint_dir=d, **kw),
                         rt, device="cpu")
    p_re, o_re = second.run(tree_util.map(torch.clone, p0), adamw.init(p0))
    assert [h["step"] for h in second.history] == [3]
    assert second.history[0]["loss"] == full.history[2]["loss"]
    assert p_re["layers"]["moe"]["router"].dtype == torch.bfloat16
    for a, b in zip(tree_util.leaves({"p": p_re, "o": o_re}),
                    tree_util.leaves({"p": p_full, "o": o_full})):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_bucket_plans_are_the_references(name):
    """The bucket plan of each full-width tree (bf16 leaves, the MoE's
    float32 router, 3-D expert leaves far over the 32 MB target) from
    shapes alone: the same boundaries, leaf dtypes and per-worker quantize
    shards at W = 2 as the reference's plan of the same shapes."""
    ref_cfg = ref_registry.get(name).cfg
    cfg = registry.get(name).cfg
    like = layers.map_specs(lambda sp: torch.empty(
        sp.shape, dtype=torch.bfloat16 if sp.dtype is None else sp.dtype,
        device="meta"), registry.param_specs(cfg))
    ref_like = jax.tree.map(
        lambda sp: jax.ShapeDtypeStruct(sp.shape, sp.dtype or jnp.bfloat16),
        ref_registry.param_specs(ref_cfg),
        is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))
    plan = gradsync.make_plan(like, target_bytes=steps.BUCKET_BYTES)
    ref_plan = ref_gradsync.make_plan(ref_like,
                                      target_bytes=steps.BUCKET_BYTES)
    assert plan.starts == ref_plan.starts
    assert plan.leaf_shapes == ref_plan.leaf_shapes
    assert [str(d).split(".")[-1] for d in plan.leaf_dtypes] == \
        [np.dtype(d).name for d in ref_plan.leaf_dtypes]
    shards = [-(-plan.bucket_size(b) // 2) for b in range(plan.n_buckets)]
    ref_shards = [-(-sum(ref_plan.leaf_sizes[i]
                         for i in ref_plan.bucket_leaves(b)) // 2)
                  for b in range(ref_plan.n_buckets)]
    assert shards == ref_shards
    if cfg.moe is not None:
        assert torch.float32 in plan.leaf_dtypes


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_family_checkpoints_cross_between_the_packages(name, tmp_path):
    """A MoE and an encdec train state (bf16 parameters, the float32
    router among them; float32 masters, m and v; the int32 step): a
    reference checkpoint restores into the port and a port checkpoint
    into the reference, bit for bit and dtype for dtype."""
    ref_cfg, cfg = _configs(name)
    host = _host_params(ref_cfg, 70)
    specs = ref_registry.param_specs(ref_cfg)
    ref_params = jax.tree.map(
        lambda x, sp: jnp.asarray(x, sp.dtype or jnp.bfloat16), host, specs,
        is_leaf=lambda x: isinstance(x, ref_layers.ParamSpec))
    ref_tree = {"params": ref_params, "opt": ref_adamw.init(ref_params)}
    ref_checkpoint.save(tmp_path / "jax", 3, ref_tree, extra={"arch": name})
    p = registry.Arch(cfg).init_params(0, "cpu", torch.bfloat16)
    like = {"params": p, "opt": adamw.init(p)}
    step, got, extra = checkpoint.restore(tmp_path / "jax", like)
    assert step == 3 and extra == {"arch": name}
    for (path, a), b in zip(tree_util.paths(got), jax.tree.leaves(ref_tree)):
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name, path
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), path)
    if cfg.moe is not None:
        assert got["params"]["layers"]["moe"]["router"].dtype == \
            torch.float32
        assert got["params"]["layers"]["moe"]["w_gate"].dtype == \
            torch.bfloat16
    checkpoint.save(tmp_path / "torch", 4, got, extra={"arch": name})
    step, back, _ = ref_checkpoint.restore(tmp_path / "torch", ref_tree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
