"""The sharding rules' parameter layouts on real ``torch.distributed``
ranks, on the CPU: tensor parallelism over ``"model"`` and FSDP over
``"data"`` for the dense family.

Two and four ``gloo`` processes (``repro_torch.core.ranks.spawn``), each
rank holding its blocks of the parameters (``layers.shard_params``),
against the reference's GSPMD steps on four virtual devices with its
parameters placed by ``layers.tree_shardings`` (three subprocesses,
started before the spawns: ``XLA_FLAGS`` must give them the devices
before JAX starts), and against the port's own one-rank runs.
Everything is float32, drawn from seeds, at 2e-5; 2 steps.

* ``baseline`` on ``{"data": 2, "model": 2}`` (FSDP and TP; the test
  config with qk-norm and tied embeddings), ``megatron`` on ``{"model":
  2}`` and on ``{"data": 1, "model": 4}`` (TP alone; a config with QKV
  bias and an untied head, whose 2 kv heads stay whole on 4 ranks): the
  loss, every first-step gradient block, the parameters and the AdamW
  master after 2 steps, each rank's blocks laid out as
  ``spec_to_pspec`` says.
* Under ``megatron``, prefill then 3 greedy decode steps through
  ``make_serve_step`` against the reference's, tokens equal; a
  ``ServeEngine`` on each rank against the unsplit engine.
* ``Trainer`` on ``{"data": 2, "model": 2}``: the unsplit history, rank
  0's checkpoint whole, a restart bit-identical.
* The shard/gather round trip bit for bit; ``rules=None``, ``pure_dp``
  and ``full_dp`` bit-equal to the path without rules; the refusals.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core import ranks
from repro_torch.launch import dryrun
from repro_torch.models import convert, layers, registry
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.train import checkpoint, rules, steps, trainer
from test_torch_ranks import DENSE, _nest, _put, _tokens

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parent.parent
# a qwen2-like config: QKV bias, no qk-norm, an untied head
QWEN2 = dict(DENSE, name="rules-qwen2", qkv_bias=True, qk_norm=False,
             tie_embeddings=False)
# name -> (config, mesh shape, preset)
CASES = {"bl22": (DENSE, {"data": 2, "model": 2}, "baseline"),
         "mg2": (QWEN2, {"model": 2}, "megatron"),
         "mg14": (QWEN2, {"data": 1, "model": 4}, "megatron")}
SERVED = ("mg2", "mg14")
ROWS, SEQ, STEPS = 4, 16, 2
PROMPT_ROWS, PROMPT, DECODE, S_MAX = 2, 8, 3, 16
TRAINER_STEPS = 4
ATOL = RTOL = 2e-5
SPAWN_TIMEOUT = 300.0
REFERENCE_TIMEOUT = 400.0


def _cfg(name):
    return ModelConfig(**CASES[name][0])


def _rules(name):
    return rules.get(CASES[name][2], _cfg(name))


def _batches(name):
    cfg = _cfg(name)
    return [_tokens(cfg.vocab_size, ROWS, SEQ, 90 + i) for i in range(STEPS)]


def _kv_heads_a_rank(name):
    cfg, shape, _ = CASES[name]
    n_kv, n = cfg["n_kv_heads"], shape["model"]
    return n_kv // n if n_kv % n == 0 else 1


def _prompt(name):
    return _tokens(_cfg(name).vocab_size, PROMPT_ROWS, PROMPT, 95)


def _inputs():
    """Both configs' parameters (the port's initialisation, the biases
    random), drawn from seeds."""
    out = {}
    for key, spec, seed in (("dense", DENSE, 30), ("qwen2", QWEN2, 31)):
        params = registry.Arch(ModelConfig(**spec)).init_params(
            seed, "cpu", torch.float32)
        if spec.get("qkv_bias"):
            rng = np.random.default_rng(seed + 100)
            for k in ("bq", "bk", "bv"):
                leaf = params["layers"]["attn"][k]
                leaf.copy_(torch.from_numpy(rng.normal(0, 0.1, leaf.shape)))
        _put(out, f"{key}/params", params)
    return out


def _params_key(name):
    return "dense/params" if CASES[name][0] is DENSE else "qwen2/params"


# ---------------------------------------------------------------------------
# the reference, on four virtual devices in subprocesses
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs  # noqa: F401  (registers archs)
from repro.models import layers, registry, transformer
from repro.models.config import ModelConfig
from repro.models.runtime import Runtime
from repro.optim import adamw
from repro.train import rules as rules_lib, steps
import test_torch_ranks as T
import test_torch_rules_ranks as R

layers.DEFAULT_DTYPE = jnp.float32
adamw.update.__defaults__ = (jnp.float32,)
inp = dict(np.load(sys.argv[1]))
out = {}
devices = np.array(jax.devices()[:4])

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

name = sys.argv[3]
spec, shape, preset = R.CASES[name]
cfg = ModelConfig(**spec)
arch = registry.Arch(cfg)
n = int(np.prod(list(shape.values())))
mesh = Mesh(devices[:n].reshape(tuple(shape.values())), tuple(shape))
rules = rules_lib.get(preset, cfg)
# no remat: the same values, less to compile
rt = Runtime(mesh=mesh, rules=rules, remat="none")
shardings = layers.tree_shardings(arch.param_specs(), rules, mesh)
rep = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
opt_shardings = {"step": NamedSharding(mesh, P()), "master": shardings,
                 "m": shardings, "v": shardings}
params = jax.device_put(jax.tree.map(jnp.asarray, T._nest(
    inp, R._params_key(name))), shardings)
batches = R._batches(name)
grads = jax.jit(jax.grad(lambda p, t: transformer.lm_loss(
    p, cfg, {"tokens": t}, rt)))(params, rep(jnp.asarray(batches[0])))
put(f"{name}/grads", grads)
step = jax.jit(steps.make_train_step(arch, rt))
p, o = params, jax.device_put(adamw.init(params), opt_shardings)
for i, t in enumerate(batches):
    p, o, m = step(p, o, {"tokens": rep(jnp.asarray(t))})
    # one placement for every call's inputs: one compile
    p, o = jax.device_put(p, shardings), jax.device_put(o, opt_shardings)
    out[f"{name}/loss{i}"] = np.asarray(m["loss"])
put(f"{name}/params", p)
put(f"{name}/master", o["master"])
if name in R.SERVED:
    prefill = jax.jit(steps.make_serve_step(arch, rt, "prefill"))
    decode = jax.jit(steps.make_serve_step(arch, rt, "decode"))
    logits, cache = prefill(params, {"tokens": rep(jnp.asarray(
        R._prompt(name)))})
    pad = [(0, 0), (0, 0), (0, R.S_MAX - R.PROMPT), (0, 0), (0, 0)]
    cache = rep({k: jnp.pad(v, pad) for k, v in cache.items()})
    for i in range(R.DECODE + 1):
        out[f"{name}/logits{i}"] = np.asarray(logits)
        if i == R.DECODE:
            break
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out[f"{name}/fed{i}"] = np.asarray(nxt)
        logits, cache = decode(params, cache, {"tokens": rep(nxt)},
                               rep(jnp.int32(R.PROMPT + i)))
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background, one process a case, stopped at the module's end."""
    d = tmp_path_factory.mktemp("rules_ranks")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
         str(d / f"reference_{name}.npz"), name], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for name in CASES}
    yield {"dir": d, "path": str(d / "inputs.npz"), "procs": procs,
           "arrays": dict(np.load(d / "inputs.npz"))}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference(inputs):
    out = {}
    for name, proc in inputs["procs"].items():
        try:
            stdout, stderr = proc.communicate(timeout=REFERENCE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, stdout + stderr
        assert "REFERENCE-OK" in stdout
        out.update(np.load(inputs["dir"] / f"reference_{name}.npz"))
    return out


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _register(name):
    cfg = _cfg(name)
    registry.register(cfg.name, lambda: cfg)
    return cfg


def _rows(t, axis):
    if axis is None:
        return torch.from_numpy(t)
    n = t.shape[0] // axis.size
    return torch.from_numpy(t[axis.index * n:(axis.index + 1) * n])


def _coords(mesh):
    return {a: mesh.axis(a).index for a in mesh.shape}


def _train(name, mesh, host, table):
    """The first step's gradient blocks and STEPS steps of
    ``make_train_step`` on this rank's rows and blocks under the rules
    ``table`` (None: none); the state comes back whole, beside this
    rank's block shapes."""
    cfg = _cfg(name)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=table)
    params = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    split = steps.splits_layout(arch, rt)
    if split:
        params = layers.shard_params(params, arch.param_specs(),
                                     rt.rules_(), mesh)
    axis = steps.batch_axis(arch, rt)
    batches = _batches(name)
    out = {"split": split, "coords": _coords(mesh),
           "shapes": {p: tuple(x.shape) for p, x in tree_util.paths(params)}}
    if split:
        loss, grads, norm = steps.layout_rank_grads(arch, rt)(
            params, {"tokens": _rows(batches[0], axis)})
        out.update(grad_loss=loss, grads=grads, norm=norm)
    step = steps.make_train_step(arch, rt, param_dtype=torch.float32,
                                 donate=True)
    opt = adamw.init(params)
    losses = []
    for t in batches:
        params, opt, metrics = step(params, opt, {"tokens": _rows(t, axis)})
        losses.append(metrics["loss"])
    state = {"params": params, "opt": opt}
    if split:
        state = layers.gather_params(state, arch.param_specs(), rt.rules_(),
                                     mesh)
    return {**out, "losses": losses, **state}


def _serve(name, mesh, host):
    """Prefill and DECODE greedy steps through ``make_serve_step`` on this
    rank's blocks, and a ``ServeEngine`` of two requests."""
    cfg = _register(name)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=_rules(name))
    params = layers.shard_params(
        convert.params_from_numpy(host, cfg, "cpu", torch.float32),
        arch.param_specs(), rt.rules_(), mesh)
    prefill = steps.make_serve_step(arch, rt, "prefill")
    decode = steps.make_serve_step(arch, rt, "decode")
    out = {}
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": torch.from_numpy(
            _prompt(name))})
        out["cache_shape"] = tuple(cache["k"].shape)
        pad = (0, 0, 0, 0, 0, S_MAX - PROMPT)
        cache = {k: torch.nn.functional.pad(v, pad) for k, v in
                 cache.items()}
        for i in range(DECODE + 1):
            out[f"logits{i}"] = logits
            if i == DECODE:
                break
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            out[f"fed{i}"] = nxt
            pos = torch.full((PROMPT_ROWS,), PROMPT + i, dtype=torch.int32)
            logits, cache = decode(params, cache, {"tokens": nxt}, pos)
    out["engine"] = _engine(name, params, rt)
    return out


def _engine(name, params, rt):
    cfg = _cfg(name)
    engine = ServeEngine(cfg.name, params, cfg,
                         EngineConfig(max_batch=2, max_len=S_MAX), rt=rt,
                         device="cpu")
    rng = np.random.default_rng(97)
    for rid in range(3):
        engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, 4 + rid,
                                                dtype=np.int32),
                              max_new_tokens=3))
    done = engine.run_until_drained()
    return {"tokens": {r.rid: list(r.tokens_out) for r in done},
            "cache_shape": tuple(engine.cache["k"].shape)}


def _trainer_run(mesh, directory, n_steps):
    cfg = _register("bl22")
    tcfg = trainer.TrainConfig(steps=n_steps, seq_len=SEQ, global_batch=ROWS,
                               log_every=1, checkpoint_every=2,
                               checkpoint_dir=directory, data_patterns=8,
                               param_dtype=torch.float32)
    rt = Runtime(mesh=mesh) if mesh is None else \
        Runtime(mesh=mesh, rules=_rules("bl22"))
    tr = trainer.Trainer(cfg.name, cfg, tcfg, rt, device="cpu")
    params, opt = tr.run()
    return tr, params, opt


def _trainer(mesh, workdir):
    tr, params, opt = _trainer_run(mesh, str(Path(workdir) / "unbroken"),
                                   TRAINER_STEPS)
    restart = str(Path(workdir) / "restart")
    _trainer_run(mesh, restart, 2)
    again, resumed, resumed_opt = _trainer_run(mesh, restart, TRAINER_STEPS)
    return {"history": tr.history, "writer": tr.writer,
            "params": params, "opt": opt, "resumed": resumed,
            "resumed_opt": resumed_opt,
            "resumed_steps": [h["step"] for h in again.history],
            "dir": str(Path(workdir) / "unbroken")}


def _round_trip(name, mesh, host):
    """Shard then gather a parameter tree and an AdamW state that nests
    it: bit for bit the tree itself."""
    cfg = _cfg(name)
    arch = registry.Arch(cfg)
    table = _rules(name)
    whole = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    tree = {"params": whole, "opt": adamw.init(whole)}
    tree["opt"]["m"] = tree_util.map(lambda x: x + 1.5, tree["opt"]["m"])
    mine = layers.shard_params(tree, arch.param_specs(), table, mesh)
    back = layers.gather_params(mine, arch.param_specs(), table, mesh)
    return all(torch.equal(a, b) for a, b in
               zip(tree_util.leaves(back), tree_util.leaves(tree)))


COLLECTIVE_KINDS = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter"}


def _count(name, mesh, host, kind, remat):
    """The collectives this rank runs in one bfloat16 step of ``kind``
    (the first gradient and its reduction, or a prefill) on its rows:
    ``{(kind, operand bytes, group): count}``, an all-reduce's operand
    its tensor, a gather's and a reduce-scatter's their input."""
    cfg = _cfg(name)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=_rules(name), remat=remat)
    params = layers.shard_params(
        convert.params_from_numpy(host, cfg, "cpu", torch.bfloat16),
        arch.param_specs(), rt.rules_(), mesh)
    axis = steps.batch_axis(arch, rt)
    counts, call = {}, ranks._call

    def record(fn, *args, **kwargs):
        operand = args[0] if fn.__name__ == "all_reduce" else args[1]
        key = (COLLECTIVE_KINDS[fn.__name__],
               operand.numel() * operand.element_size(),
               dist.get_world_size(kwargs["group"]))
        counts[key] = counts.get(key, 0) + 1
        return call(fn, *args, **kwargs)

    ranks._call = record
    try:
        if kind == "train":
            steps.layout_rank_grads(arch, rt)(
                params, {"tokens": _rows(_batches(name)[0], axis)})
        else:
            with torch.no_grad():
                arch.prefill_fn()(params, {"tokens": _rows(_prompt(name),
                                                            axis)}, rt)
    finally:
        ranks._call = call
    return counts


def _counts(name, mesh, host):
    return {f"{kind}/{remat}": _count(name, mesh, host, kind, remat)
            for kind, remat in (("train", "none"), ("train", "full"),
                                ("prefill", "none"))}


def _four_ranks(rank, device, inputs_path, workdir):
    inp = dict(np.load(inputs_path))
    out = {}
    mesh = ranks.RankMesh(CASES["bl22"][1], device)
    host = _nest(inp, _params_key("bl22"))
    out["bl22"] = _train("bl22", mesh, host, _rules("bl22"))
    out["round_trip"] = _round_trip("bl22", mesh, host)
    out["unlaid"] = {"none": _train("bl22", mesh, host, None)}
    for preset in ("pure_dp", "full_dp"):
        out["unlaid"][preset] = _train("bl22", mesh, host,
                                       rules.get(preset, _cfg("bl22")))
    out["trainer"] = _trainer(mesh, workdir)
    out["bl22_counts"] = _counts("bl22", mesh, host)
    mesh = ranks.RankMesh(CASES["mg14"][1], device)
    host = _nest(inp, _params_key("mg14"))
    out["mg14"] = _train("mg14", mesh, host, _rules("mg14"))
    out["mg14_serve"] = _serve("mg14", mesh, host)
    out["mg14_round_trip"] = _round_trip("mg14", mesh, host)
    out["mg14_counts"] = _counts("mg14", mesh, host)
    return out


def _two_ranks(rank, device, inputs_path):
    inp = dict(np.load(inputs_path))
    mesh = ranks.RankMesh(CASES["mg2"][1], device)
    host = _nest(inp, _params_key("mg2"))
    return {"mg2": _train("mg2", mesh, host, _rules("mg2")),
            "mg2_counts": _counts("mg2", mesh, host),
            "mg2_serve": _serve("mg2", mesh, host)}


@pytest.fixture(scope="module")
def four(inputs):
    return ranks.spawn(_four_ranks, ["cpu"] * 4, inputs["path"],
                       str(inputs["dir"]), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def two(inputs):
    return ranks.spawn(_two_ranks, ["cpu"] * 2, inputs["path"],
                       timeout=SPAWN_TIMEOUT)


def _results(name, four, two):
    return [r[name] for r in (two if name.startswith("mg2") else four)]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _ref_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _block(whole, partition, coords, shape):
    """This rank's block of ``whole`` under ``partition`` (``coords``: the
    rank's index on each mesh axis)."""
    for dim, entry in enumerate(partition):
        if entry is None:
            continue
        axes = layers.entry_axes(entry)
        index, size = 0, 1
        for a in axes:
            index, size = index * shape[a] + coords[a], size * shape[a]
        n = whole.shape[dim] // size
        whole = np.take(whole, range(index * n, (index + 1) * n), axis=dim)
    return whole


def _stand_in(shape):
    return types.SimpleNamespace(
        shape=dict(shape), world_size=int(np.prod(list(shape.values()))),
        size=lambda a: shape.get(a, 1))


def _close_to_reference(got, reference, name):
    """Losses, the whole parameters and AdamW master after the steps."""
    for i, loss in enumerate(got["losses"]):
        np.testing.assert_allclose(float(loss),
                                   float(reference[f"{name}/loss{i}"]),
                                   rtol=RTOL, err_msg=f"{name} loss{i}")
    for key, tree in (("params", got["params"]),
                      ("master", got["opt"]["master"])):
        want = _nest(reference, f"{name}/{key}")
        for path, leaf in tree_util.paths(tree):
            np.testing.assert_allclose(
                leaf.numpy(), _ref_leaf(want, path), rtol=RTOL, atol=ATOL,
                err_msg=f"{name}/{key}/{path}")


def _equal_trees(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(tree_util.paths(a), lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_are_laid_out_as_spec_to_pspec_says(four, two, name):
    """Each rank holds its block of every leaf: the shape of
    ``layers.shard_shape``; under ``megatron`` on four ranks the 2 kv
    heads whole, the 4 q heads one a rank."""
    cfg = _cfg(name)
    specs = dict(layers.spec_paths(registry.Arch(cfg).param_specs()))
    table, shape = _rules(name), CASES[name][1]
    for got in _results(name, four, two):
        assert got["split"]
        for path, spec in specs.items():
            assert got["shapes"][path] == layers.shard_shape(
                spec, table, _stand_in(shape)), path
    if name == "mg14":
        got = _results(name, four, two)[0]["shapes"]
        assert got["layers/attn/wq"][2] == 1 and \
            got["layers/attn/wk"][2] == cfg.n_kv_heads


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_gradient_blocks_match_the_reference(four, two, reference,
                                                   name):
    """The loss and every rank's block of every leaf of the first
    gradient against the same block of the reference's GSPMD gradient;
    the global norm against the whole gradient's."""
    want = _nest(reference, f"{name}/grads")
    table, shape = _rules(name), CASES[name][1]
    layout = layers.tree_layout(registry.Arch(_cfg(name)).param_specs(),
                                table, _stand_in(shape))
    norm = np.sqrt(sum(float(np.sum(np.square(leaf.astype(np.float64))))
                       for leaf in tree_util.leaves(want)))
    for got in _results(name, four, two):
        np.testing.assert_allclose(float(got["grad_loss"]),
                                   float(reference[f"{name}/loss0"]),
                                   rtol=RTOL)
        for path, leaf in tree_util.paths(got["grads"]):
            block = _block(_ref_leaf(want, path), layout[path],
                           got["coords"], shape)
            np.testing.assert_allclose(leaf.numpy(), block, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}/{path}")
        np.testing.assert_allclose(float(got["norm"]), norm, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_the_reference(four, two, reference, name):
    """Two steps: the losses, and the parameters and AdamW master
    gathered whole."""
    for got in _results(name, four, two):
        _close_to_reference(got, reference, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_holding_the_same_blocks_hold_the_same_bits(four, two, name):
    """After the steps, every rank's gathered state is the same, bit for
    bit: the blocks a rank shares with another (over ``"data"`` under
    ``megatron``, the whole leaves everywhere) never diverge."""
    results = _results(name, four, two)
    for other in results[1:]:
        _equal_trees({"p": other["params"], "o": other["opt"],
                      "l": other["losses"]},
                     {"p": results[0]["params"], "o": results[0]["opt"],
                      "l": results[0]["losses"]})


@pytest.mark.parametrize("name", SERVED)
def test_prefill_and_decode_match_the_reference(four, two, reference,
                                                name):
    """``megatron``: the prefill's logits and DECODE greedy steps'
    through ``make_serve_step``, gathered whole, against the reference's;
    the greedy tokens equal; each rank's cache holds the kv heads its q
    heads read."""
    cfg = _cfg(name)
    for got in _results(f"{name}_serve", four, two):
        assert got["cache_shape"] == (cfg.n_layers, PROMPT_ROWS, PROMPT,
                                      _kv_heads_a_rank(name), cfg.head_dim_)
        for i in range(DECODE + 1):
            np.testing.assert_allclose(
                got[f"logits{i}"].numpy(), reference[f"{name}/logits{i}"],
                rtol=RTOL, atol=ATOL, err_msg=f"{name} logits{i}")
        for i in range(DECODE):
            assert np.array_equal(got[f"fed{i}"].numpy(),
                                  reference[f"{name}/fed{i}"]), i


@pytest.fixture(scope="module")
def unsplit(inputs, tmp_path_factory):
    """The port's one-rank runs the ranks are held to: the engine of each
    served case and the Trainer."""
    out = {}
    for name in SERVED:
        cfg = _register(name)
        params = convert.params_from_numpy(
            _nest(inputs["arrays"], _params_key(name)), cfg, "cpu",
            torch.float32)
        with torch.no_grad():
            out[name] = _engine(name, params, Runtime())
    d = tmp_path_factory.mktemp("rules_trainer")
    tr, params, _ = _trainer_run(None, str(d), TRAINER_STEPS)
    out["trainer"] = {"history": tr.history, "params": params}
    return out


@pytest.mark.parametrize("name", SERVED)
def test_serve_engine_on_the_ranks_serves_the_unsplit_tokens(four, two,
                                                             unsplit, name):
    """Each rank's engine, fed the same requests, emits the unsplit
    engine's tokens; its cache holds this rank's kv heads."""
    for got in _results(f"{name}_serve", four, two):
        assert got["engine"]["tokens"] == unsplit[name]["tokens"]
        assert got["engine"]["cache_shape"][3] == _kv_heads_a_rank(name)
        assert unsplit[name]["cache_shape"][3] == _cfg(name).n_kv_heads


def test_trainer_over_a_laid_out_mesh_matches_the_unsplit_trainer(
        four, unsplit):
    want = unsplit["trainer"]["history"]
    for r in four:
        got = r["trainer"]["history"]
        assert len(got) == len(want) == TRAINER_STEPS
        for h, w in zip(got, want):
            assert h["step"] == w["step"] and h["lr"] == w["lr"]
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(h[k], w[k], rtol=RTOL, err_msg=k)


def test_trainer_rank_zero_writes_the_whole_tree(four, unsplit):
    """Rank 0 alone writes; its checkpoint holds the whole tree in the
    reference's layout, within 2e-5 of the unsplit run's."""
    assert [r["trainer"]["writer"] for r in four] == [True, False, False,
                                                      False]
    want = unsplit["trainer"]["params"]
    like = {"params": want, "opt": adamw.init(want)}
    step, tree, _ = checkpoint.restore(four[0]["trainer"]["dir"], like)
    assert step == TRAINER_STEPS
    for (path, got), w in zip(tree_util.paths(tree["params"]),
                              tree_util.leaves(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_trainer_restart_on_a_laid_out_mesh_is_bit_identical(four):
    for r in four:
        t = r["trainer"]
        assert t["resumed_steps"] == [3, 4]
        _equal_trees(t["resumed"], t["params"])
        _equal_trees(t["resumed_opt"], t["opt"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_dry_run_counts_the_collectives_the_ranks_run(four, two, name):
    """``dryrun.layout_collectives`` of each case's cell (the tiny
    config's step on this mesh) names every collective a rank runs in a
    bfloat16 step, each with its operand and group, as often as the rank
    runs it: the gradient and its reduction without remat and under
    ``full``, and a prefill."""
    cfg, shape = _cfg(name), CASES[name][1]
    table = _rules(name)
    assert registry.rules_layout(cfg, table, _stand_in(shape))
    cells = {"train": ShapeConfig("rules-train", SEQ, ROWS, "train"),
             "prefill": ShapeConfig("rules-prefill", PROMPT, PROMPT_ROWS,
                                    "prefill")}
    for got in _results(f"{name}_counts", four, two):
        for key, counted in got.items():
            kind, remat = key.split("/")
            batch_axes = dryrun._batch_axes(table, _stand_in(shape),
                                            cells[kind].global_batch)
            want = {}
            for op, operand, group, count in dryrun.layout_collectives(
                    registry.Arch(cfg), cells[kind], table, shape,
                    batch_axes, remat):
                want[(op, operand, group)] = \
                    want.get((op, operand, group), 0) + count
            assert counted == want, key


@pytest.mark.parametrize("key", ["round_trip", "mg14_round_trip"])
def test_shard_then_gather_is_bit_exact(four, key):
    assert all(r[key] for r in four)


@pytest.mark.parametrize("preset", ["pure_dp", "full_dp"])
def test_layouts_that_split_no_leaf_are_the_path_without_rules(four,
                                                               preset):
    """``pure_dp`` and ``full_dp`` split no dense leaf: their steps are
    the path without rules, bit for bit."""
    for r in four:
        got, want = r["unlaid"][preset], r["unlaid"]["none"]
        assert not got["split"] and not want["split"]
        _equal_trees({"p": got["params"], "o": got["opt"],
                      "l": got["losses"]},
                     {"p": want["params"], "o": want["opt"],
                      "l": want["losses"]})


def test_rules_keep_a_hashable_runtime_that_compares_by_value():
    a = Runtime(rules=rules.get("baseline", _cfg("bl22")))
    b = Runtime(rules=dict(rules.get("baseline", _cfg("bl22"))))
    assert a == b and hash(a) == hash(b)
    assert a.rules_() == rules.get("baseline", _cfg("bl22"))
    assert a != Runtime(rules=rules.get("megatron", _cfg("bl22")))
    assert Runtime().rules_() == layers.DEFAULT_RULES
    assert Runtime().rules is None and Runtime().tp_axis() is None


def _runtime(shape, preset, cfg, gradsync="gspmd"):
    return Runtime(mesh=_stand_in(shape), gradsync=gradsync,
                   rules=rules.get(preset, cfg))


@pytest.mark.parametrize("preset", ["seq_model", "megatron_seq",
                                    "ssm_seq"])
def test_sequence_parallel_presets_are_refused(preset):
    """``seq_model``, ``megatron_seq`` and ``ssm_seq`` run now (their
    steps on ranks are ``tests/test_torch_seq_parallel.py``'s and
    ``tests/test_torch_ssm_seq.py``'s): the layout comes back, every
    leaf partitioned as ``spec_to_pspec`` says."""
    cfg = _cfg("bl22")
    rt = _runtime({"data": 2, "model": 2}, preset, cfg)
    got = registry.layout(cfg, rt)
    specs = dict(layers.spec_paths(registry.param_specs(cfg)))
    assert got is not None and set(got) == set(specs)
    for path, spec in specs.items():
        assert got[path] == layers.spec_to_pspec(spec, rt.rules_(),
                                                 rt.mesh), path


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "zamba2-2.7b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_other_families_split_by_the_rules_are_refused(arch):
    """The families that waited for their layouts run them now: under
    ``baseline`` on ``{"data": 2, "model": 2}`` and ``megatron`` on
    ``{"model": 2}`` the layout comes back, every leaf partitioned as
    ``spec_to_pspec`` says, and the train step runs on it; what is still
    refused is a table that puts ``"seq"`` on ``"model"`` with the heads
    there and the MLP whole (neither Megatron's form nor ``ssm_seq``'s)
    and ``fsdp_only`` on a split ``"data"`` axis."""
    cfg = registry.get(arch).cfg
    specs = dict(layers.spec_paths(registry.param_specs(cfg)))
    for shape, preset in (({"data": 2, "model": 2}, "baseline"),
                          ({"model": 2}, "megatron")):
        rt = _runtime(shape, preset, cfg)
        got = registry.layout(cfg, rt)
        assert got is not None and set(got) == set(specs)
        for path, spec in specs.items():
            assert got[path] == layers.spec_to_pspec(spec, rt.rules_(),
                                                     rt.mesh), path
        assert steps.splits_layout(registry.Arch(cfg), rt)
    rt = _runtime({"data": 2, "model": 2}, "seq_model", cfg)
    mixed = dataclasses.replace(rt, rules=dict(rt.rules_(), mlp=None))
    with pytest.raises(ValueError, match="mixers"):
        registry.layout(cfg, mixed)


def test_the_moe_under_pure_dp_runs_its_expert_path():
    """``pure_dp`` keeps every non-expert leaf whole: the MoE takes the
    path without rules, its experts split by ``moe``."""
    cfg = registry.get("qwen2-moe-a2.7b").cfg
    rt = _runtime({"data": 2, "model": 2}, "pure_dp", cfg)
    assert registry.layout(cfg, rt) is None
    assert steps.splits_experts(registry.Arch(cfg), rt)
    assert not steps.splits_layout(registry.Arch(cfg), rt)


def test_fsdp_only_on_a_data_axis_is_refused_naming_leaf_and_axis():
    cfg = _cfg("bl22")
    rt = _runtime({"data": 2, "model": 2}, "fsdp_only", cfg)
    with pytest.raises(ValueError, match=r"embed: .*'data'"):
        registry.layout(cfg, rt)
    with pytest.raises(ValueError, match="'data'"):
        layers.shard_params({}, registry.Arch(cfg).param_specs(),
                            rt.rules_(), rt.mesh)
    # one data rank: nothing maps "data" twice
    assert registry.layout(cfg, _runtime({"data": 1, "model": 2},
                                         "fsdp_only", cfg)) is None


def test_spindle_modes_and_one_rank_keep_every_leaf_whole():
    cfg = _cfg("bl22")
    arch = registry.Arch(cfg)
    for mode in ("spindle", "spindle_per_tensor", "spindle_compressed"):
        assert not steps.splits_layout(arch, _runtime(
            {"data": 2, "model": 2}, "baseline", cfg, mode))
    assert steps.splits_layout(arch, _runtime({"data": 2, "model": 2},
                                              "baseline", cfg))
    assert registry.layout(cfg, Runtime(rules=rules.get("baseline",
                                                        cfg))) is None


def test_kv_heads_that_neither_split_nor_group_are_refused():
    from repro_torch.models import attention
    cfg = dataclasses.replace(_cfg("bl22"), n_heads=6, n_kv_heads=3)
    assert attention.kv_heads_here(cfg, 6) == 3
    assert attention.kv_heads_here(cfg, 2) == 1
    with pytest.raises(ValueError, match="kv heads"):
        attention.kv_heads_here(cfg, 3)
