"""The port across real ``torch.distributed`` ranks, on the CPU.

Two and four ``gloo`` processes (``repro_torch.core.ranks.spawn``), each
holding its own tensors, against the port's folded workers
(``Runtime(dp_workers=W)``, the W workers a leading tensor dim on one
device) and against the reference across virtual devices.  One spawn a
world size serves every check (module-scoped fixtures, so the file stays
cheap); the reference runs once, in a subprocess, because ``XLA_FLAGS``
must give it two host devices before JAX starts (as
``tests/test_stacked.py`` does).  Everything is float32 and drawn from
seeds.

* The reductions: per tensor, fused, with validity and compressed (with
  and without error-feedback residuals) at n = 2 bit-equal to the folded
  forms on the same per-worker gradients; at n = 4 the ranks equal to
  each other bit for bit (``gloo``'s ring sums in its own order) and the
  folded forms within 1e-6 relative (the compressed within 1e-6 plus
  one quantization step, as ``tests/test_torch_gradsync.py``).
* ``make_train_step`` over 2 ranks for the three Spindle modes: 2 steps,
  loss, parameters and the whole AdamW state bit-equal to
  ``Runtime(dp_workers=2)``; against the reference's ``make_train_step``
  on a 2-device data mesh (its ``adamw.update`` default patched to
  float32 in the subprocess, as the port's ``param_dtype``) at 2e-5.  At
  4 ranks every rank's state is bit-identical to every other's.
* ``Trainer`` over 2 ranks: the history equals the folded ``Trainer``'s
  (but the wall clock), rank 0 alone writes checkpoints, and a restart
  resumes bit-identically.
* Expert parallelism over a ``{"data": 1, "model": 2}`` mesh: the MoE
  block, a tiny MoE model's ``lm_loss``, a decode step, prefill then
  greedy decode and a ``ServeEngine``, against the port's unsplit path
  (routes and aux loss equal, values at 2e-5) and the reference's
  shard_mapped ``_ffn`` on a (1, 2) mesh at 2e-5 (aux within 1e-6).
* ``sst.push_rows`` exactly equal to the reference's ``push_rows`` under
  ``make_push_rows``'s ``shard_map`` on two virtual devices (with the
  replication check off: this jax cannot infer it through ``all_gather``
  and ``max``, so ``make_push_rows`` itself refuses to trace).
* ``Runtime``: a mesh compares by identity, ``dp_workers`` and a mesh of
  more than one rank together raise, and a mesh with no device named
  wants the card.  (Training on the production mesh axes, expert
  parallelism included, is ``tests/test_torch_ranks_train.py``.)
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.core import gradsync, ranks, sst
from repro_torch.models import convert, moe, registry, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.train import checkpoint, steps, trainer

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parent.parent
MODES = ("spindle", "spindle_per_tensor", "spindle_compressed")
DENSE = dict(name="ranks-test", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
             qk_norm=True, tie_embeddings=True, rope_theta=1e6)
MOE_NAME = "qwen2-moe-a2.7b"
MOE_CHANGES = dict(n_routed=6, ep_pad_to=8)     # 6 experts in 8 slots
GRAD_SHAPES = [(17,), (8, 9), (3, 4, 5), (128,), (2, 2)]
PLAN_BYTES = 256                    # several buckets of those gradients
TRAIN_ROWS, TRAIN_SEQ = 4, 16
EP_ROWS, EP_SEQ, S_MAX, DECODE_STEPS = 2, 12, 20, 3
SST_COLUMNS = {"received_num": (16,), "delivered_num": (), "wedged": (4,)}
ATOL = RTOL = 2e-5
AUX_RTOL = 1e-6
TIE_GAP = 1e-5
SPAWN_TIMEOUT = 240.0
REFERENCE_TIMEOUT = 300.0


def _moe_cfg() -> ModelConfig:
    cfg = registry.get(MOE_NAME).cfg.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **MOE_CHANGES))


def _nest(flat, prefix):
    """The nested tree under ``prefix`` of a ``/``-keyed flat mapping."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(value)
    return out


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s),
                                                dtype=np.int32)


def _grads(seed, n):
    """Per-worker gradients, ``(n, *shape)`` each."""
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=(n,) + s).astype(np.float32)
            for i, s in enumerate(GRAD_SHAPES)}


def _sst_tables(seed, n):
    """(own rows, stale local copy) of the SST's int32 columns, ``(n,
    ...)`` each; the copy is ahead of the rows in some entries."""
    rng = np.random.default_rng(seed)
    own, local = {}, {}
    for name, shape in SST_COLUMNS.items():
        own[name] = rng.integers(0, 1000, size=(n,) + shape, dtype=np.int32)
        local[name] = (own[name] + rng.integers(-50, 50, size=own[name].shape)
                       ).astype(np.int32)
    return own, local


def _put(out, prefix, tree):
    for path, leaf in tree_util.paths(tree):
        out[f"{prefix}/{path}"] = leaf.numpy()


def _inputs():
    """Every input of both packages, drawn from seeds: the dense and MoE
    parameters (the port's initialisation, the MoE's q/k/v biases
    random), the MoE block's input, token batches and a random cache."""
    out = {}
    _put(out, "dense/params",
         registry.Arch(ModelConfig(**DENSE)).init_params(30, "cpu",
                                                         torch.float32))
    mcfg = _moe_cfg()
    mp = registry.Arch(mcfg).init_params(40, "cpu", torch.float32)
    rng = np.random.default_rng(41)
    for k in ("bq", "bk", "bv"):
        leaf = mp["layers"]["attn"][k]
        leaf.copy_(torch.from_numpy(rng.normal(0, 0.1, leaf.shape)))
    _put(out, "moe/params", mp)
    out["ep/x"] = np.random.default_rng(42).normal(
        size=(EP_ROWS, EP_SEQ, mcfg.d_model)).astype(np.float32)
    out["ep/tokens"] = _tokens(mcfg.vocab_size, EP_ROWS, EP_SEQ, 43)
    crng = np.random.default_rng(44)
    for k in ("k", "v"):
        out[f"ep/cache/{k}"] = crng.normal(
            size=(mcfg.n_layers, EP_ROWS, S_MAX, mcfg.n_kv_heads,
                  mcfg.head_dim_)).astype(np.float32)
    out["ep/step_tokens"] = _tokens(mcfg.vocab_size, EP_ROWS, 1, 45)
    out["ep/pos"] = np.array([5, 17], np.int32)
    return out


# ---------------------------------------------------------------------------
# the reference, on virtual devices in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs  # noqa: F401  (registers archs)
from repro.core import sst
from repro.models import layers, registry, transformer
from repro.models.config import ModelConfig
from repro.models.runtime import Runtime
from repro.optim import adamw
from repro.train import steps
import test_torch_ranks as T

layers.DEFAULT_DTYPE = jnp.float32
adamw.update.__defaults__ = (jnp.float32,)
inp = dict(np.load(sys.argv[1]))
out = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

def tree(prefix):
    return jax.tree.map(jnp.asarray, T._nest(inp, prefix))

devices = np.array(jax.devices()[:2])
# the data-parallel train step, three Spindle modes, 2 steps
cfg = ModelConfig(**T.DENSE)
params = tree("dense/params")
batches = [T._tokens(cfg.vocab_size, T.TRAIN_ROWS, T.TRAIN_SEQ, 31 + i)
           for i in range(2)]
for mode in T.MODES:
    rt = Runtime(mesh=Mesh(devices, ("data",)), gradsync=mode)
    step = jax.jit(steps.make_train_step(registry.Arch(cfg), rt))
    p, o = params, adamw.init(params)
    for i, t in enumerate(batches):
        p, o, m = step(p, o, {"tokens": jnp.asarray(t)})
        out[f"train/{mode}/loss{i}"] = np.asarray(m["loss"])
    put(f"train/{mode}/params", p)
    put(f"train/{mode}/master", o["master"])
# expert parallelism over a (1, 2) ("data", "model") mesh
mcfg = T._moe_cfg()
mp = tree("moe/params")
rt = Runtime(mesh=Mesh(devices.reshape(1, 2), ("data", "model")))
assert rt.moe_ep_size() == 2
layer0 = jax.tree.map(lambda a: a[0], mp["layers"])
y, aux = jax.jit(lambda lp, xx: transformer._ffn(lp, mcfg, xx, rt))(
    layer0, jnp.asarray(inp["ep/x"]))
out["ep/y"], out["ep/aux"] = np.asarray(y), np.asarray(aux)
out["ep/loss"] = np.asarray(jax.jit(lambda q, t: transformer.lm_loss(
    q, mcfg, {"tokens": t}, rt))(mp, jnp.asarray(inp["ep/tokens"])))
logits, new = jax.jit(lambda q, c, t, ps: transformer.decode_step(
    q, mcfg, c, t, ps, rt))(
    mp, {k: jnp.asarray(inp[f"ep/cache/{k}"]) for k in ("k", "v")},
    jnp.asarray(inp["ep/step_tokens"]), jnp.asarray(inp["ep/pos"]))
out["ep/logits"] = np.asarray(logits)
for k in ("k", "v"):
    out[f"ep/new_cache/{k}"] = np.asarray(new[k])
# the SST push across two devices: make_push_rows's shard_map of push_rows
# with its specs; its own wrapper keeps the replication check, which this
# jax cannot infer through all_gather + max, so the check is off here
own, local = T._sst_tables(50, 2)
push = jax.jit(jax.shard_map(
    lambda o, c: sst.push_rows(o, c, "x"), mesh=Mesh(devices, ("x",)),
    in_specs=(P("x"), P()), out_specs=P(), check_vma=False))
merged = push({k: jnp.asarray(v) for k, v in own.items()},
              {k: jnp.asarray(v) for k, v in local.items()})
for k, v in merged.items():
    out[f"sst/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background (it needs no port result), stopped at the module's end."""
    d = tmp_path_factory.mktemp("ranks")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=2").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
         str(d / "reference.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield {"dir": d, "path": str(d / "inputs.npz"), "proc": proc,
           "arrays": dict(np.load(d / "inputs.npz"))}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(inputs):
    try:
        stdout, stderr = inputs["proc"].communicate(timeout=REFERENCE_TIMEOUT)
    except subprocess.TimeoutExpired:
        inputs["proc"].kill()
        raise
    assert inputs["proc"].returncode == 0, stdout + stderr
    assert "REFERENCE-OK" in stdout
    return dict(np.load(inputs["dir"] / "reference.npz"))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _reductions(mesh, n):
    """Every rank form on this rank's row of the seeded gradients."""
    axis = mesh.axis("data")
    r = axis.index
    mine = {k: torch.from_numpy(v[r]) for k, v in _grads(10 + n, n).items()}
    plan = gradsync.make_plan(mine, target_bytes=PLAN_BYTES)
    valid = torch.tensor(float(r % 3 != 1))
    state = gradsync.CompressionState(residuals=[
        torch.from_numpy(np.random.default_rng(60 + b).normal(
            size=(n, plan.bucket_size(b))).astype(np.float32)[r])
        for b in range(plan.n_buckets)])
    out = {"per_tensor": gradsync.per_tensor_psum_mean(mine, axis),
           "fused": gradsync.fused_psum_mean(mine, plan, axis)}
    out["valid"], out["count"] = gradsync.psum_with_validity(
        mine, valid, plan, axis)
    out["valid_leafwise"], _ = gradsync.psum_with_validity(mine, valid,
                                                           axis=axis)
    out["fresh"], none = gradsync.compressed_psum_mean(mine, plan, None,
                                                       Runtime(), axis)
    assert none is None
    out["kept"], new = gradsync.compressed_psum_mean(mine, plan, state,
                                                     Runtime(), axis)
    out["residuals"] = new.residuals
    return out


def _train(mesh, mode, host, batches, n_steps):
    cfg = ModelConfig(**DENSE)
    axis = mesh.axis("data")
    params = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    step = steps.make_train_step(registry.Arch(cfg),
                                 Runtime(gradsync=mode, mesh=mesh),
                                 param_dtype=torch.float32, donate=True)
    opt = adamw.init(params)
    losses = []
    for t in batches[:n_steps]:
        rows = t.shape[0] // axis.size
        mine = torch.from_numpy(t[axis.index * rows:(axis.index + 1) * rows])
        params, opt, metrics = step(params, opt, {"tokens": mine})
        losses.append(metrics["loss"])
    return {"params": params, "opt": opt, "losses": losses}


def _trainer_run(mesh, directory, n_steps, writes):
    cfg = ModelConfig(**DENSE)
    registry.register(DENSE["name"], lambda: cfg)
    tcfg = trainer.TrainConfig(steps=n_steps, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_ROWS, log_every=1,
                               checkpoint_every=2, checkpoint_dir=directory,
                               data_patterns=8, param_dtype=torch.float32)
    save = checkpoint.save

    def recording(*args, **kwargs):
        writes.append(args[1])
        return save(*args, **kwargs)

    checkpoint.save = recording
    try:
        tr = trainer.Trainer(DENSE["name"], cfg, tcfg,
                             Runtime(gradsync="spindle_compressed",
                                     mesh=mesh))
        params, _ = tr.run()
    finally:
        checkpoint.save = save
    return tr, params


def _trainer(mesh, workdir):
    writes = []
    tr, params = _trainer_run(mesh, str(Path(workdir) / "unbroken"), 4,
                              writes)
    history = [{k: v for k, v in h.items() if k != "wall_s"}
               for h in tr.history]
    restart = str(Path(workdir) / "restart")
    _trainer_run(mesh, restart, 2, writes)
    again, resumed = _trainer_run(mesh, restart, 4, writes)
    return {"history": history, "params": params, "resumed": resumed,
            "resumed_steps": [h["step"] for h in again.history],
            "writer": tr.writer, "writes": writes,
            "sync": (tr.sync.sent_step, tr.sync.delivered_step)}


def _recording_routes(routes):
    route = moe.route

    def recording(p, cfg, x):
        idx, w, aux = route(p, cfg, x)
        probs = torch.softmax(moe.router_logits(p, x), -1)
        top = torch.sort(probs, -1, descending=True).values
        k = cfg.moe.top_k
        routes.append((idx, float((top[:, k - 1] - top[:, k]).min())))
        return idx, w, aux

    return recording


def _ep_run(params, cfg, rt, inp):
    """The MoE block, the loss, a decode step over the reference's random
    cache, and prefill then greedy decode, through the entry points."""
    arch = registry.Arch(cfg)
    layer0 = transformer.layer_params(params["layers"], 0)["moe"]
    x = torch.from_numpy(inp["ep/x"])
    if rt.moe_ep_size() > 1:
        y, aux = moe.moe_block(layer0, cfg, x, ep_axis=rt.ep_axis,
                               mesh=rt.mesh)
    else:
        y, aux = moe.moe_block(layer0, cfg, x)
    tokens = torch.from_numpy(inp["ep/tokens"])
    out = {"y": y, "aux": aux,
           "loss": arch.loss_fn()(params, cfg, {"tokens": tokens}, rt)}
    cache = convert.cache_from_numpy(
        {k: inp[f"ep/cache/{k}"] for k in ("k", "v")}, cfg, EP_ROWS, S_MAX,
        "cpu", torch.float32)
    decode = steps.make_serve_step(arch, rt, "decode")
    step_tokens = torch.from_numpy(inp["ep/step_tokens"])
    out["logits"], _ = decode(params, cache, {"tokens": step_tokens},
                              torch.from_numpy(inp["ep/pos"]))
    out["cache"] = cache
    kv = convert.cache_from_numpy(
        {k: np.zeros((cfg.n_layers, EP_ROWS, S_MAX, cfg.n_kv_heads,
                      cfg.head_dim_), np.float32) for k in ("k", "v")},
        cfg, EP_ROWS, S_MAX, "cpu", torch.float32)
    logits, _ = arch.prefill_fn()(params, {"tokens": tokens}, rt, cache=kv)
    greedy = [logits]
    pos = torch.full((EP_ROWS,), EP_SEQ, dtype=torch.int32)
    for _ in range(DECODE_STEPS):
        nxt = greedy[-1].argmax(-1, keepdim=True).to(torch.int32)
        logits, _ = decode(params, kv, {"tokens": nxt}, pos)
        greedy.append(logits)
        pos = pos + 1
    out["greedy"] = torch.stack(greedy)
    engine = ServeEngine(MOE_NAME, params, cfg,
                         EngineConfig(max_batch=2, max_len=S_MAX), rt=rt,
                         device="cpu")
    rng = np.random.default_rng(46)
    for rid in range(3):
        engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, 5 + rid,
                                                dtype=np.int32),
                              max_new_tokens=4))
    engine.run_until_drained()
    out["served"] = {r.rid: list(r.tokens_out) for r in engine.completed}
    return out


def _ep(mesh, inp):
    cfg = _moe_cfg()
    axis = mesh.axis("model")
    full = convert.params_from_numpy(_nest(inp, "moe/params"), cfg, "cpu",
                                     torch.float32)
    mine = moe.shard_experts(full, axis.index, axis.size)
    route = moe.route
    out = {}
    try:
        for name, params, rt in (("ep", mine, Runtime(mesh=mesh)),
                                 ("unsplit", full, Runtime())):
            routes = []
            moe.route = _recording_routes(routes)
            out[name] = _ep_run(params, cfg, rt, inp)
            out[name]["routes"] = [idx for idx, _ in routes]
            out[name]["gap"] = min(gap for _, gap in routes)
    finally:
        moe.route = route
    out["expert_rows"] = mine["layers"]["moe"]["w_gate"].shape[1]
    return out


def _runtime_checks(mesh, device):
    other = ranks.RankMesh(dict(mesh.shape), device)
    a, b = Runtime(mesh=mesh), Runtime(mesh=other)
    out = {"same": a == Runtime(mesh=mesh)
           and hash(a) == hash(Runtime(mesh=mesh)),
           "differ": a != b and len({a, b}) == 2,
           "spmd": a.spmd and not Runtime().spmd, "ranks": a.ranks}
    try:
        Runtime(mesh=mesh, dp_workers=2)
        out["both"] = None
    except ValueError as e:
        out["both"] = str(e)
    try:
        ranks.RankMesh(dict(mesh.shape))
        out["no_device"] = None
    except RuntimeError as e:
        out["no_device"] = str(e)
    return out


def _two_ranks(rank, device, inputs_path, workdir):
    inp = dict(np.load(inputs_path))
    mesh = ranks.RankMesh({"data": 2}, device)
    host = _nest(inp, "dense/params")
    batches = [_tokens(DENSE["vocab_size"], TRAIN_ROWS, TRAIN_SEQ, 31 + i)
               for i in range(2)]
    own, local = _sst_tables(50, 2)
    return {
        "rank": (mesh.rank, mesh.axis("data").index, mesh.backend),
        "reductions": _reductions(mesh, 2),
        "train": {mode: _train(mesh, mode, host, batches, 2)
                  for mode in MODES + ("gspmd",)},
        "trainer": _trainer(mesh, workdir),
        "runtime": _runtime_checks(mesh, device),
        "ep": _ep(ranks.RankMesh({"data": 1, "model": 2}, device), inp),
        "sst": sst.push_rows(
            {k: torch.from_numpy(v[rank:rank + 1]) for k, v in own.items()},
            {k: torch.from_numpy(v) for k, v in local.items()},
            mesh.axis("data")),
    }


def _four_ranks(rank, device, inputs_path):
    host = _nest(dict(np.load(inputs_path)), "dense/params")
    mesh = ranks.RankMesh({"data": 4}, device)
    batches = [_tokens(DENSE["vocab_size"], TRAIN_ROWS, TRAIN_SEQ, 31 + i)
               for i in range(2)]
    return {"reductions": _reductions(mesh, 4),
            "train": {mode: _train(mesh, mode, host, batches, 2)
                      for mode in MODES}}


@pytest.fixture(scope="module")
def two(inputs):
    return ranks.spawn(_two_ranks, ["cpu", "cpu"], inputs["path"],
                       str(inputs["dir"]), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def four(inputs):
    return ranks.spawn(_four_ranks, ["cpu"] * 4, inputs["path"],
                       timeout=SPAWN_TIMEOUT)


# ---------------------------------------------------------------------------
# the folded path the ranks are held to
# ---------------------------------------------------------------------------

def _folded_reductions(n):
    stacked = {k: torch.from_numpy(v) for k, v in _grads(10 + n, n).items()}
    plan = gradsync.make_plan({k: v[0] for k, v in stacked.items()},
                              target_bytes=PLAN_BYTES)
    valid = torch.tensor([float(r % 3 != 1) for r in range(n)])
    state = gradsync.CompressionState(residuals=[
        torch.from_numpy(np.random.default_rng(60 + b).normal(
            size=(n, plan.bucket_size(b))).astype(np.float32))
        for b in range(plan.n_buckets)])
    out = {"per_tensor": gradsync.per_tensor_psum_mean(stacked),
           "fused": gradsync.fused_psum_mean(stacked, plan)}
    out["valid"], out["count"] = gradsync.psum_with_validity(stacked, valid,
                                                             plan)
    out["valid_leafwise"], _ = gradsync.psum_with_validity(stacked, valid)
    out["fresh"], _ = gradsync.compressed_psum_mean(stacked, plan, None)
    out["kept"], new = gradsync.compressed_psum_mean(stacked, plan, state)
    out["residuals"] = new.residuals
    return out, plan


def _folded_train(mode, host, workers):
    cfg = ModelConfig(**DENSE)
    params = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    step = steps.make_train_step(registry.Arch(cfg),
                                 Runtime(gradsync=mode, dp_workers=workers),
                                 param_dtype=torch.float32, donate=True)
    opt = adamw.init(params)
    losses = []
    for i in range(2):
        t = _tokens(DENSE["vocab_size"], TRAIN_ROWS, TRAIN_SEQ, 31 + i)
        params, opt, metrics = step(params, opt,
                                    {"tokens": torch.from_numpy(t)})
        losses.append(metrics["loss"])
    return {"params": params, "opt": opt, "losses": losses}


def _equal_trees(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(tree_util.paths(a), lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def _close_trees(a, b, rtol=1e-6, atol=0.0):
    for (path, x), y in zip(tree_util.paths(a), tree_util.leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_spawn_gives_each_rank_its_device_and_gloo(two):
    assert [r["rank"] for r in two] == [(0, 0, "gloo"), (1, 1, "gloo")]


def test_reductions_at_two_ranks_bit_equal_the_folded_workers(two):
    want, _ = _folded_reductions(2)
    for r, got in enumerate(r["reductions"] for r in two):
        for key in ("per_tensor", "fused", "valid", "valid_leafwise",
                    "count", "fresh", "kept"):
            _equal_trees(got[key], want[key])
        for res, w in zip(got["residuals"], want["residuals"]):
            assert torch.equal(res, w[r])       # nonzero on its own shard
    assert float(want["count"]) == 1.0
    assert any(float(x.abs().max()) > 0 for x in want["residuals"])


def test_reductions_at_four_ranks_agree(four):
    """Every rank the same bits; the folded sums within 1e-6 relative (the
    compressed within 1e-6 plus one quantization step of each bucket)."""
    want, plan = _folded_reductions(4)
    first = four[0]["reductions"]
    for other in four[1:]:
        for key in ("per_tensor", "fused", "valid", "valid_leafwise",
                    "count", "fresh", "kept"):
            _equal_trees(other["reductions"][key], first[key])
    for key in ("per_tensor", "fused", "valid", "valid_leafwise"):
        _close_trees(first[key], want[key], atol=1e-7)
    assert float(first["count"]) == float(want["count"]) == 3.0
    for key in ("fresh", "kept"):
        for b in range(plan.n_buckets):
            names = [sorted(want[key])[i] for i in plan.bucket_leaves(b)]
            mean = torch.cat([want[key][k].reshape(-1) for k in names])
            step = float(mean.abs().max()) / 127.0
            for k in names:
                np.testing.assert_allclose(
                    first[key][k].numpy(), want[key][k].numpy(), rtol=0,
                    atol=1e-6 + 1.01 * step, err_msg=f"{key}/{k}")
    for r, got in enumerate(four):
        for res, w in zip(got["reductions"]["residuals"], want["residuals"]):
            step = float(w.abs().max()) / 127.0
            np.testing.assert_allclose(res.numpy(), w[r].numpy(), rtol=0,
                                       atol=1e-6 + 1.01 * step)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_over_two_ranks_bit_equals_the_folded_step(
        two, inputs, mode):
    want = _folded_train(mode, _nest(inputs["arrays"], "dense/params"), 2)
    for r in two:
        got = r["train"][mode]
        _equal_trees(got["losses"], want["losses"])
        _equal_trees(got["params"], want["params"])
        _equal_trees(got["opt"], want["opt"])


def test_gspmd_over_ranks_is_the_per_tensor_mean(two):
    """``gspmd`` on ranks: each rank's gradient and one all-reduce mean a
    leaf, the reduction a framework's data parallelism inserts — the
    numbers of ``spindle_per_tensor``, bit for bit."""
    for r in two:
        _equal_trees(r["train"]["gspmd"], r["train"]["spindle_per_tensor"])


@pytest.mark.parametrize("mode", MODES)
def test_train_step_over_two_ranks_matches_the_reference_mesh(
        two, reference, mode):
    got = two[0]["train"][mode]
    for i, loss in enumerate(got["losses"]):
        np.testing.assert_allclose(float(loss),
                                   float(reference[f"train/{mode}/loss{i}"]),
                                   rtol=RTOL)
    for name, tree in (("params", got["params"]),
                       ("master", got["opt"]["master"])):
        want = _nest(reference, f"train/{mode}/{name}")
        for path, leaf in tree_util.paths(tree):
            ref_leaf = want
            for k in path.split("/"):
                ref_leaf = ref_leaf[k]
            np.testing.assert_allclose(leaf.numpy(), ref_leaf, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}/{path}")


@pytest.mark.parametrize("mode", MODES)
def test_train_step_over_four_ranks_keeps_every_rank_identical(
        four, inputs, mode):
    """Parameters may never diverge: every rank's loss, parameters and
    AdamW state bit-identical; the folded W = 4 step within 1e-6."""
    first = four[0]["train"][mode]
    for other in four[1:]:
        _equal_trees(other["train"][mode], first)
    want = _folded_train(mode, _nest(inputs["arrays"], "dense/params"), 4)
    _close_trees(first["losses"], want["losses"])
    _close_trees(first["opt"]["master"], want["opt"]["master"], atol=1e-6)


def test_trainer_over_two_ranks_matches_the_folded_trainer(two, tmp_path):
    cfg = ModelConfig(**DENSE)
    registry.register(DENSE["name"], lambda: cfg)
    tcfg = trainer.TrainConfig(steps=4, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_ROWS, log_every=1,
                               checkpoint_every=2, data_patterns=8,
                               param_dtype=torch.float32)
    folded = trainer.Trainer(DENSE["name"], cfg, tcfg,
                             Runtime(gradsync="spindle_compressed",
                                     dp_workers=2), device="cpu")
    params, _ = folded.run()
    want = [{k: v for k, v in h.items() if k != "wall_s"}
            for h in folded.history]
    for r in two:
        got = r["trainer"]
        assert got["history"] == want
        _equal_trees(got["params"], params)
        assert got["sync"] == (4, 4)


def test_trainer_rank_zero_alone_writes_and_restarts_bit_identically(two):
    zero, one = (r["trainer"] for r in two)
    assert zero["writer"] and not one["writer"]
    # a run saves every 2 steps and once more at its end: the unbroken
    # run at 2, 4, 4, the first restart run at 2, 2, the resumed at 4, 4
    assert zero["writes"] == [2, 4, 4, 2, 2, 4, 4] and one["writes"] == []
    for got in (zero, one):
        assert got["resumed_steps"] == [3, 4]
        _equal_trees(got["resumed"], got["params"])


def test_expert_parallel_moe_matches_the_unsplit_path(two):
    """Each rank holds 4 of the 8 expert slots; routes are equal and the
    aux loss exactly so; the values within 2e-5 (the ranks' partial sums
    are added after each rank's own k-order sum)."""
    for r in two:
        ep, whole = r["ep"]["ep"], r["ep"]["unsplit"]
        assert r["ep"]["expert_rows"] == 4
        assert len(ep["routes"]) == len(whole["routes"]) > 0
        for a, b in zip(ep["routes"], whole["routes"]):
            assert torch.equal(a, b)
        assert whole["gap"] > TIE_GAP
        assert torch.equal(ep["aux"], whole["aux"])
        for key in ("y", "loss", "logits", "greedy"):
            np.testing.assert_allclose(ep[key].numpy(), whole[key].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        for k in ("k", "v"):
            np.testing.assert_allclose(ep["cache"][k].numpy(),
                                       whole["cache"][k].numpy(),
                                       rtol=RTOL, atol=ATOL)
    _equal_trees(two[0]["ep"]["ep"]["greedy"], two[1]["ep"]["ep"]["greedy"])


def test_expert_parallel_serve_engine_serves_the_unsplit_tokens(two):
    """``ServeEngine`` on each rank of the expert-parallel mesh (the
    ranks step in lockstep: the same requests, the same slots) drains
    three requests with the unsplit engine's tokens."""
    for r in two:
        ep, whole = r["ep"]["ep"]["served"], r["ep"]["unsplit"]["served"]
        assert sorted(ep) == [0, 1, 2]
        assert all(len(t) == 4 for t in ep.values())
        assert ep == whole


def test_expert_parallel_moe_matches_the_reference_mesh(two, reference):
    for r in two:
        ep = r["ep"]["ep"]
        np.testing.assert_allclose(ep["y"].numpy(), reference["ep/y"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(ep["aux"]),
                                   float(reference["ep/aux"]), rtol=AUX_RTOL)
        np.testing.assert_allclose(float(ep["loss"]),
                                   float(reference["ep/loss"]), rtol=RTOL)
        np.testing.assert_allclose(ep["logits"].numpy(),
                                   reference["ep/logits"], rtol=RTOL,
                                   atol=ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(ep["cache"][k].numpy(),
                                       reference[f"ep/new_cache/{k}"],
                                       rtol=RTOL, atol=ATOL)


def test_push_rows_equals_the_reference(two, reference):
    for r in two:
        for k in SST_COLUMNS:
            got = r["sst"][k]
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), reference[f"sst/{k}"])


def test_runtime_mesh_compares_by_identity_and_excludes_dp_workers(two):
    for r in two:
        chk = r["runtime"]
        assert chk["same"] and chk["differ"] and chk["spmd"]
        assert chk["ranks"] == 2
        assert chk["both"] is not None and "pick one" in chk["both"]
        assert chk["no_device"] is not None and "CUDA" in chk["no_device"]
