"""The port's training plane against the reference's, on the CPU.

AdamW (``optim/adamw.py``), the data pipeline, checkpoints, the train step
with every gradient-reduction mode, the Trainer, and the gradient the
port gives its forward kernel sites (``kernels/autograd.py``).  The
reference runs in float32 (``repro.models.layers.DEFAULT_DTYPE`` patched,
parameters drawn by the reference and carried across with
``params_from_numpy``), through its XLA path.  The reference reduces
across devices only; its Spindle reductions are run here over a vmapped
worker axis ``"w"`` (as ``tests/test_gradsync.py`` does) from the same
functions its ``_manual_grads`` calls, while the port folds the workers
onto one device.  Tolerances, stated per test: losses, gradient norms and
learning rates 1e-5 relative, master weights 1e-5 absolute (a first
AdamW step moves a weight by at most ``lr`` = 3e-6 whatever the size of
its gradient, so gradients one quantization step apart stay within it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs  # noqa: F401  (registers archs)
from repro.core import gradsync as ref_gradsync
from repro.data import pipeline as ref_pipeline
from repro.launch.mesh import make_smoke_mesh
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import SSMConfig as RefSSMConfig
from repro.models.runtime import Runtime as RefRuntime
from repro.optim import adamw as ref_adamw
from repro.train import checkpoint as ref_checkpoint
from repro.train import steps as ref_steps
from repro.train import trainer as ref_trainer
from repro_torch import api
from repro_torch import tree as tree_util
from repro_torch.data import pipeline
from repro_torch.kernels import autograd, flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as sc
from repro_torch.models import convert, registry
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, steps

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DENSE = dict(name="train-test", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
             qk_norm=True, tie_embeddings=True, rope_theta=1e6)
SSM = dict(name="train-ssm-test", family="ssm", n_layers=2, d_model=64,
           n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=256, head_dim=16)
SSM_INNER = dict(d_state=16, head_dim=16, expand=2, chunk=8, n_groups=2)
MODES = ("spindle", "spindle_per_tensor", "spindle_compressed")


@pytest.fixture
def f32_reference(monkeypatch):
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)


def _configs(ssm=False):
    if ssm:
        return (RefModelConfig(**SSM, ssm=RefSSMConfig(**SSM_INNER)),
                ModelConfig(**SSM, ssm=SSMConfig(**SSM_INNER)))
    return RefModelConfig(**DENSE), ModelConfig(**DENSE)


def _params(ref_cfg, cfg, seed):
    """Reference-drawn float32 parameters in both packages."""
    host = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        ref_layers.init_tree(ref_registry.param_specs(ref_cfg),
                                             jax.random.key(seed)))
    return (jax.tree.map(jnp.asarray, host),
            convert.params_from_numpy(host, cfg, "cpu", torch.float32))


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s),
                                                dtype=np.int32)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _close_tree(got, want_jax, atol):
    for (path, g), w in zip(tree_util.paths(got), jax.tree.leaves(want_jax)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_matches_the_reference():
    cfg = adamw.OptConfig(warmup_steps=10, decay_steps=50)
    ref_cfg = ref_adamw.OptConfig(warmup_steps=10, decay_steps=50)
    steps_ = np.arange(0, 70, 3, dtype=np.int32)
    got = adamw.schedule(cfg, torch.from_numpy(steps_)).numpy()
    want = np.asarray(ref_adamw.schedule(ref_cfg, jnp.asarray(steps_)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("inplace", [False, True])
def test_three_updates_match_the_reference(inplace):
    """Three AdamW updates on seeded gradients (one step clipped) at 1e-6
    relative; in place (donated) or not, the same numbers."""
    rng = np.random.default_rng(50)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (2, 3, 4)}}
    host = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = adamw.OptConfig(warmup_steps=2, decay_steps=6, clip_norm=3.0)
    ref_cfg = ref_adamw.OptConfig(warmup_steps=2, decay_steps=6, clip_norm=3.0)
    params = tree_util.map(torch.tensor, host)     # copies: updated in place
    state = adamw.init(params)
    ref_params = jax.tree.map(jnp.asarray, host)
    ref_state = ref_adamw.init(ref_params)
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * (step + 1))
                         .astype(np.float32), host)
        params, state, metrics = adamw.update(
            cfg, tree_util.map(torch.from_numpy, g), state, torch.float32,
            params=params if inplace else None)
        ref_params, ref_state, ref_metrics = ref_adamw.update(
            ref_cfg, jax.tree.map(jnp.asarray, g), ref_state,
            param_dtype=jnp.float32)
        for k in ("grad_norm", "lr"):
            assert _rel(metrics[k], ref_metrics[k]) <= 1e-6
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        for part in ("master", "m", "v"):
            for a, b in zip(tree_util.leaves(state[part]),
                            jax.tree.leaves(ref_state[part])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-12)
    assert all(p.dtype == torch.float32 for p in tree_util.leaves(params))


def test_update_casts_every_leaf_like_the_reference():
    params = {"w": torch.ones(3), "a_log": torch.zeros(2)}
    state = adamw.init(params)
    new, _, _ = adamw.update(adamw.OptConfig(), {"w": torch.ones(3),
                                                 "a_log": torch.ones(2)},
                             state)
    assert all(p.dtype == torch.bfloat16 for p in new.values())
    with pytest.raises(NotImplementedError, match="item 15"):
        adamw.abstract_state(params)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_pipeline_tokens_are_the_references(seed):
    kw = dict(seq_len=96, global_batch=6, vocab_size=1000, seed=seed,
              n_patterns=16, pattern_len=32)
    cfg, ref_cfg = pipeline.DataConfig(**kw), ref_pipeline.DataConfig(**kw)
    for step in (0, 3):
        got = pipeline.global_batch(cfg, step)["tokens"]
        want = ref_pipeline.global_batch(ref_cfg, step)["tokens"]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for ranks in (2, 3):
            parts = [pipeline.ShardedLoader(cfg, r, ranks).batch(step)
                     ["tokens"] for r in range(ranks)]
            ref_parts = [ref_pipeline.ShardedLoader(ref_cfg, r, ranks)
                         .batch(step)["tokens"] for r in range(ranks)]
            assert np.concatenate(parts).tobytes() == got.tobytes()
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(parts, ref_parts))
        new = pipeline.reshard(cfg, 2, 3)
        assert np.concatenate([new(r).batch(step)["tokens"]
                               for r in range(3)]).tobytes() == got.tobytes()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(rng):
    f = rng.normal(size=(3, 5)).astype(np.float32)
    h = rng.normal(size=(4, 2)).astype(np.float32)
    return {"params": {"w": f, "h": h}, "opt": {"step": np.int32(7)}}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX-saved tree with bfloat16 leaves restores into the port, and
    a port-saved one restores in JAX, bit for bit."""
    host = _ckpt_tree(np.random.default_rng(60))
    jax_tree = {"params": {"w": jnp.asarray(host["params"]["w"]),
                           "h": jnp.asarray(host["params"]["h"],
                                            jnp.bfloat16)},
                "opt": {"step": jnp.asarray(host["opt"]["step"])}}
    ref_checkpoint.save(tmp_path / "jax", 5, jax_tree, extra={"arch": "x"})
    like = {"params": {"w": torch.zeros(3, 5),
                       "h": torch.zeros(4, 2, dtype=torch.bfloat16)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    step, got, extra = checkpoint.restore(tmp_path / "jax", like)
    assert step == 5 and extra == {"arch": "x"}
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["h"].float(), torch.tensor(
        np.asarray(jax_tree["params"]["h"].astype(jnp.float32))))
    assert torch.equal(got["params"]["w"],
                       torch.from_numpy(host["params"]["w"]))
    assert int(got["opt"]["step"]) == 7

    checkpoint.save(tmp_path / "torch", 9, got, extra={"arch": "y"})
    step, back, extra = ref_checkpoint.restore(tmp_path / "torch", jax_tree)
    assert step == 9 and extra == {"arch": "y"}
    assert back["params"]["h"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_tree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    manifest = (tmp_path / "torch" / "step_000000009" / "manifest.json")
    assert '"dtype": "bfloat16"' in manifest.read_text()


def test_latest_prune_and_errors(tmp_path):
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    assert checkpoint.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, tree)
    for s in (1, 2, 3, 4):
        checkpoint.save(tmp_path, s, tree_util.map(lambda t: t + s, tree))
        assert checkpoint.latest_step(tmp_path) == s
        assert ref_checkpoint.latest_step(tmp_path) == s
    checkpoint.save(tmp_path, 4, tree)          # idempotent: unchanged
    step, got, _ = checkpoint.restore(tmp_path, tree)
    assert step == 4 and torch.equal(got["a"], torch.arange(4.0) + 4)
    step, got, _ = checkpoint.restore(tmp_path, tree, step=2)
    assert torch.equal(got["b"]["c"], torch.ones(2, 2) + 2)
    checkpoint.prune(tmp_path, keep=2)
    left = sorted(p.name for p in tmp_path.glob("step_*"))
    assert left == ["step_000000003", "step_000000004"]
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(tmp_path, {"a": torch.zeros(5),
                                      "b": {"c": torch.ones(2, 2)}})
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(tmp_path, {**tree, "z": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _ref_spindle_step(ref_arch, mode, workers, bucket_bytes, opt_cfg):
    """The reference's ``_manual_grads`` local step over a vmapped worker
    axis (each worker its rows of every batch leaf), then its
    ``adamw.update``."""
    loss_fn = ref_arch.loss_fn()
    cfg = ref_arch.cfg
    rt = RefRuntime()

    def local(params, batch):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, cfg, batch, rt))(params)
        loss = jax.lax.psum(loss, "w") / workers
        if mode == "spindle_per_tensor":
            grads = ref_gradsync.per_tensor_psum_mean(grads, "w")
        elif mode == "spindle_compressed":
            plan = ref_gradsync.make_plan(grads, target_bytes=bucket_bytes)
            state = ref_gradsync.CompressionState.init(plan)
            grads, _ = ref_gradsync.compressed_psum_mean(
                grads, plan, state, "w", jax.lax.axis_index("w"))
        else:
            plan = ref_gradsync.make_plan(grads, target_bytes=bucket_bytes)
            grads = ref_gradsync.fused_psum_mean(grads, plan, "w")
        return loss, grads

    @jax.jit
    def step(params, opt_state, batch):
        shards = jax.tree.map(
            lambda x: x.reshape(workers, -1, *x.shape[1:]), batch)
        loss, grads = jax.vmap(local, in_axes=(None, 0),
                               axis_name="w")(params, shards)
        grads = jax.tree.map(lambda g: g[0], grads)
        new_p, new_o, metrics = ref_adamw.update(opt_cfg, grads, opt_state)
        metrics["loss"] = loss[0]
        return new_p, new_o, metrics

    return step


def _check_step(got, want):
    (p, o, m), (ref_p, ref_o, ref_m) = got, want
    for k in ("loss", "grad_norm", "lr"):
        assert _rel(m[k], ref_m[k]) <= 1e-5, (k, float(m[k]),
                                               float(ref_m[k]))
    _close_tree(o["master"], ref_o["master"], 1e-5)
    assert all(x.dtype == torch.bfloat16 for x in tree_util.leaves(p))
    _close_tree(p, ref_p, 1e-2)         # bf16 casts of the masters


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("mode", ("gspmd",) + MODES)
def test_single_worker_step_matches_the_reference(mode):
    """W = 1 with every mode: the gradient of the whole batch, as the
    reference's step on its one-device smoke mesh."""
    ref_cfg, cfg = _configs()
    ref_p, p = _params(ref_cfg, cfg, seed=70)
    tokens = _tokens(cfg.vocab_size, 2, 24, seed=71)
    step = steps.make_train_step(registry.Arch(cfg),
                                 Runtime(gradsync=mode))
    ref_step = ref_steps.make_train_step(
        ref_registry.Arch(ref_cfg),
        RefRuntime(mesh=make_smoke_mesh(), gradsync=mode))
    got = step(p, adamw.init(p), {"tokens": torch.from_numpy(tokens)})
    want = jax.jit(ref_step)(ref_p, ref_adamw.init(ref_p),
                             {"tokens": jnp.asarray(tokens)})
    _check_step(got, want)


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_worker_reductions_match_the_reference(mode, workers):
    """W = 2 and 4 workers folded onto the CPU against the reference's
    per-worker value_and_grad over a vmapped axis and its reduction; the
    compressed mode with a small bucket target (several buckets)."""
    ref_cfg, cfg = _configs()
    ref_p, p = _params(ref_cfg, cfg, seed=72)
    tokens = _tokens(cfg.vocab_size, 4, 24, seed=73 + workers)
    bucket = 4096 if mode == "spindle_compressed" else steps.BUCKET_BYTES
    rt = Runtime(gradsync=mode, dp_workers=workers)
    step = steps.make_train_step(registry.Arch(cfg), rt, bucket_bytes=bucket)
    ref_step = _ref_spindle_step(ref_registry.Arch(ref_cfg), mode, workers,
                                 bucket, ref_adamw.OptConfig())
    got = step(p, adamw.init(p), {"tokens": torch.from_numpy(tokens)})
    want = ref_step(ref_p, ref_adamw.init(ref_p),
                    {"tokens": jnp.asarray(tokens)})
    _check_step(got, want)
    losses, stacked = steps.worker_grads(registry.Arch(cfg), rt)(
        p, {"tokens": torch.from_numpy(tokens)})
    assert losses.shape == (workers,)
    assert float(losses.mean()) == pytest.approx(float(got[2]["loss"]),
                                                 rel=1e-6)
    assert all(g.shape[0] == workers for g in tree_util.leaves(stacked))


@pytest.mark.usefixtures("f32_reference")
@pytest.mark.parametrize("mode,workers", [("gspmd", 1), ("spindle", 2)])
def test_mamba2_step_matches_the_reference(mode, workers):
    ref_cfg, cfg = _configs(ssm=True)
    ref_p, p = _params(ref_cfg, cfg, seed=74)
    tokens = _tokens(cfg.vocab_size, 2, 32, seed=75)
    step = steps.make_train_step(
        registry.Arch(cfg), Runtime(gradsync=mode, dp_workers=workers))
    if workers == 1:
        ref_step = jax.jit(ref_steps.make_train_step(
            ref_registry.Arch(ref_cfg), RefRuntime()))
        want = ref_step(ref_p, ref_adamw.init(ref_p),
                        {"tokens": jnp.asarray(tokens)})
    else:
        ref_step = _ref_spindle_step(ref_registry.Arch(ref_cfg), mode,
                                     workers, steps.BUCKET_BYTES,
                                     ref_adamw.OptConfig())
        want = ref_step(ref_p, ref_adamw.init(ref_p),
                        {"tokens": jnp.asarray(tokens)})
    got = step(p, adamw.init(p), {"tokens": torch.from_numpy(tokens)})
    _check_step(got, want)


def test_train_step_leaves_or_donates_its_arguments():
    _, cfg = _configs()
    p = registry.Arch(cfg).init_params(1, "cpu", torch.bfloat16)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 2, 16, 2))}
    before = tree_util.map(torch.clone, p)
    opt = adamw.init(p)
    new_p, new_o, _ = steps.make_train_step(registry.Arch(cfg), Runtime())(
        p, opt, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(p),
                                                 tree_util.leaves(before)))
    assert int(opt["step"]) == 0 and int(new_o["step"]) == 1
    donated = steps.make_train_step(registry.Arch(cfg), Runtime(),
                                    donate=True)
    d_p, d_o, _ = donated(p, opt, batch)
    assert all(a is b for a, b in zip(tree_util.leaves(d_p),
                                      tree_util.leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(d_p),
                                                 tree_util.leaves(new_p)))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_util.leaves(d_o["master"]), tree_util.leaves(new_o["master"])))
    with pytest.raises(ValueError, match="do not split"):
        steps.make_train_step(registry.Arch(cfg), Runtime(
            gradsync="spindle", dp_workers=3))(p, opt, batch)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("f32_reference")
def test_trainer_matches_the_reference_trainer(tmp_path):
    """Four steps of ``Trainer.run`` from the same float32 weights, fed
    the same token stream.  Both cast the parameters to bfloat16 after
    every step (the reference's ``adamw.update``), so step 1 runs in
    float32 (loss within 1e-5 relative) and the later steps in bfloat16
    parameters (within 2e-2, the bf16 bar)."""
    ref_cfg, cfg = _configs()
    ref_registry.register(DENSE["name"], lambda: ref_cfg)
    registry.register(DENSE["name"], lambda: cfg)
    ref_p, p = _params(ref_cfg, cfg, seed=80)
    kw = dict(steps=4, seq_len=32, global_batch=4, log_every=1,
              data_patterns=8)
    ref_tr = ref_trainer.Trainer(DENSE["name"], ref_cfg,
                                 ref_trainer.TrainConfig(**kw), RefRuntime())
    # the reference donates both trees: give its optimizer state buffers
    # of its own (a float32 master would alias the float32 parameters)
    ref_tr.run(ref_p, ref_adamw.init(jax.tree.map(jnp.copy, ref_p)))
    rt = Runtime(gradsync="spindle_compressed", dp_workers=1)
    tr = api.Trainer(DENSE["name"], cfg, api.TrainConfig(**kw), rt,
                     device="cpu")
    tr.run(p, adamw.init(p))
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4]
    for i, (h, r) in enumerate(zip(tr.history, ref_tr.history)):
        tol = 1e-5 if i == 0 else 2e-2
        for k in ("loss", "grad_norm", "lr"):
            assert _rel(h[k], r[k]) <= tol, (i, k, h[k], r[k])
    assert tr.sync.sent_step == 4


def test_trainer_restarts_bit_identically(tmp_path):
    """Save at step 2 and stop; a fresh Trainer restores and runs steps
    3-4: parameters, optimizer state and losses equal the uninterrupted
    run's, bit for bit (W = 2, compressed reduction, float32)."""
    _, cfg = _configs()
    rt = Runtime(gradsync="spindle_compressed", dp_workers=2)
    kw = dict(seq_len=32, global_batch=4, log_every=1, data_patterns=8,
              param_dtype=torch.float32, checkpoint_every=2)
    full = api.Trainer("qwen3-1.7b", cfg, api.TrainConfig(steps=4, **kw), rt,
                       device="cpu")
    p_full, o_full = full.run()
    d = str(tmp_path / "ckpt")
    first = api.Trainer("qwen3-1.7b", cfg,
                        api.TrainConfig(steps=2, checkpoint_dir=d, **kw), rt,
                        device="cpu")
    first.run()
    assert checkpoint.latest_step(d) == 2 and first.sync.delivered_step == 2
    second = api.Trainer("qwen3-1.7b", cfg,
                         api.TrainConfig(steps=4, checkpoint_dir=d, **kw),
                         rt, device="cpu")
    p_re, o_re = second.run()
    assert second.sync.delivered_step == 4
    assert [h["step"] for h in second.history] == [3, 4]
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in full.history[2:]]
    for a, b in zip(tree_util.leaves({"p": p_re, "o": o_re}),
                    tree_util.leaves({"p": p_full, "o": o_full})):
        assert torch.equal(a, b)


def test_trainer_batches_and_devices():
    _, cfg = _configs()
    tr = api.Trainer("qwen3-1.7b", cfg, api.TrainConfig(seq_len=16,
                                                        global_batch=2),
                     device="cpu")
    want = pipeline.global_batch(tr.data_cfg, 3)["tokens"]
    assert np.array_equal(tr._batch_for(3)["tokens"].numpy(), want)
    p, o = tr.init_state(5)
    assert all(x.dtype == torch.bfloat16 for x in tree_util.leaves(p))
    assert all(x.dtype == torch.float32
               for x in tree_util.leaves(o["master"]))
    # the stub frontends: the encdec's frames and targets, the vlm's
    # patches and text, cut from the same token stream, one-hot in the
    # weights' dtype
    for name in ("qwen2-moe-a2.7b", "internvl2-26b", "seamless-m4t-medium"):
        small = registry.get(name).cfg.reduced()
        fam = api.Trainer(name, small,
                          api.TrainConfig(seq_len=16, global_batch=2),
                          device="cpu")
        toks = pipeline.global_batch(fam.data_cfg, 3)["tokens"]
        batch = fam._batch_for(3)
        cut = {"encdec": 8, "vlm": small.vlm.n_patches if small.vlm
               else 0}.get(small.family, 0)
        assert np.array_equal(batch["tokens"].numpy(), toks[:, cut:])
        stub = batch.get("frames", batch.get("patches"))
        if small.family == "moe":
            assert stub is None
            continue
        width = stub.shape[-1]
        assert stub.dtype == torch.bfloat16
        assert stub.shape == (2, cut, width)
        assert torch.equal(stub.argmax(-1), torch.from_numpy(
            toks[:, :cut] % width).long())
        assert torch.equal(stub.float().sum(-1), torch.ones(2, cut))
    with pytest.raises(KeyError):
        api.Trainer("no-such-arch", cfg, api.TrainConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Trainer("qwen3-1.7b", cfg, api.TrainConfig())
    with pytest.raises(ValueError, match="gradsync"):
        Runtime(gradsync="allreduce")
    with pytest.raises(ValueError, match="dp_workers"):
        Runtime(dp_workers=0)
    assert api.make_train_step is steps.make_train_step
    assert api.gradsync.SyncState().delivered_step == 0


# ---------------------------------------------------------------------------
# the gradient of the forward kernel sites
# ---------------------------------------------------------------------------

def _sites(rng):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    ssd = (f(1, 32, 2, 16), 0.5 * f(1, 32, 2),
           torch.from_numpy(rng.uniform(-1, 0.5, 2).astype(np.float32)),
           0.3 * f(1, 32, 1, 16), 0.3 * f(1, 32, 1, 16),
           torch.from_numpy(rng.uniform(0, 1, 2).astype(np.float32)),
           torch.from_numpy(rng.uniform(-0.5, 0.5, 2).astype(np.float32)))
    return {
        "rms_norm": ((f(6, 32), 1 + 0.1 * f(32)),
                     lambda x, w: rn.rms_norm_plain(x, w, 1e-6)),
        "rms_norm_residual": ((f(6, 32), f(6, 32), 1 + 0.1 * f(32)),
                              lambda x, r, w: rn.rms_norm_residual_plain(
                                  x, r, w, 1e-6)),
        "flash_attention": ((f(1, 12, 4, 16), f(1, 12, 2, 16),
                             f(1, 12, 2, 16)),
                            lambda q, k, v: fa.flash_attention_plain(
                                q, k, v, True)),
        "ssd_scan": (ssd, lambda *t: sc.ssd_scan_plain(*t, 8)),
    }


@pytest.mark.parametrize("site", ["rms_norm", "rms_norm_residual",
                                  "flash_attention", "ssd_scan"])
def test_kernel_sites_take_the_plain_versions_gradient(site):
    """``kernel_with_plain_grad`` with the plain version standing in for
    the kernel: values and gradients exactly plain autograd's, every
    output carrying a ``grad_fn``; without a gradient it is the kernel
    call itself."""
    rng = np.random.default_rng(90)
    inputs, plain = _sites(rng)[site]
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    got = autograd.kernel_with_plain_grad(plain, plain, *a)
    want = plain(*b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(g.grad_fn is not None for g in got)
    cots = [torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(
        np.float32)) for w in want]
    ga = torch.autograd.grad(got, a, cots)
    gb = torch.autograd.grad(want, b, cots)
    for x, y in zip(got + ga, want + gb):
        assert torch.equal(x, y)
    calls = []
    with torch.no_grad():
        autograd.kernel_with_plain_grad(
            lambda *t: calls.append("kernel") or plain(*t), plain, *a)
    assert calls == ["kernel"]


def test_flash_decode_refuses_a_gradient():
    from repro_torch.kernels import ops
    q = torch.zeros(1, 4, 64, requires_grad=True)
    cache = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="item 17"):
        ops.flash_decode(q, cache, cache, 3)
    with torch.no_grad():
        assert ops.flash_decode(q, cache, cache, 3).shape == (1, 4, 64)
