"""Training on the reference's production mesh axes across real
``torch.distributed`` ranks, on the CPU.

Two and four ``gloo`` processes (``repro_torch.core.ranks.spawn``), each
rank building every mesh it needs, against the reference's
``make_train_step`` on four virtual devices (one subprocess, started
before the spawns: ``XLA_FLAGS`` must give it the devices before JAX
starts) and against the port's own one-rank step.  Everything is
float32, drawn from seeds, at 2e-5 unless said otherwise; 2 steps.

* The MoE's experts split over ``"model"`` under ``gspmd`` (the
  reference's ``_ffn`` in ``shard_map``): on ``{"data": 1, "model": 2}``
  the loss, every first-step gradient leaf (the router's, and each
  rank's rows of the experts'), the parameters and the AdamW master
  against the reference's (1, 2) mesh and the port's unsplit step; on
  ``{"data": 2, "model": 2}`` against the reference's (2, 2) mesh, whose
  reported loss is the cross-entropy mean plus data shard 0's aux and
  whose gradient is that of the mean aux.
* Two data axes: ``{"pod": 2, "data": 2}``, the dense model, the three
  Spindle modes and ``gspmd`` with ``dp_axes=("pod", "data")``.
* The Spindle modes on a mesh with a model axis (no expert parallelism,
  as in the reference): the MoE on ``{"data": 1, "model": 2}`` and, with
  ``gspmd`` too, on ``{"pod": 2, "data": 1, "model": 2}``.
* Ranks the reference replicates hold the same bits.
* ``Trainer`` over ``{"data": 1, "model": 2}``: the unsplit Trainer's
  history, rank 0's checkpoint whole, a restart bit-identical.
* ``RankMesh``'s product axes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.core import ranks
from repro_torch.models import convert, moe, registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, steps, trainer
from test_torch_ranks import DENSE, MOE_NAME, _moe_cfg, _nest, _put, _tokens

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parent.parent
MODES = ("spindle", "spindle_per_tensor", "spindle_compressed")
ALL_MODES = MODES + ("gspmd",)
ROWS, MOE_SEQ, DENSE_SEQ, STEPS = 4, 12, 16, 2
TRAINER_STEPS = 4
ATOL = RTOL = 2e-5
TIE_GAP = 1e-5
SPAWN_TIMEOUT = 300.0
REFERENCE_TIMEOUT = 400.0
# meshes: (name, shape, dp_axes)
EP12 = ("ep12", {"data": 1, "model": 2}, ("data",))
EP22 = ("ep22", {"data": 2, "model": 2}, ("data",))
POD = ("pod", {"pod": 2, "data": 2}, ("pod", "data"))
PDM = ("pdm", {"pod": 2, "data": 1, "model": 2}, ("pod", "data"))


def _batches(cfg, seq, seed):
    return [_tokens(cfg.vocab_size, ROWS, seq, seed + i)
            for i in range(STEPS)]


def _inputs():
    """The dense and MoE parameters (the port's initialisation, the MoE's
    q/k/v biases random), drawn from seeds."""
    out = {}
    _put(out, "dense/params",
         registry.Arch(ModelConfig(**DENSE)).init_params(30, "cpu",
                                                         torch.float32))
    mp = registry.Arch(_moe_cfg()).init_params(40, "cpu", torch.float32)
    rng = np.random.default_rng(41)
    for k in ("bq", "bk", "bv"):
        leaf = mp["layers"]["attn"][k]
        leaf.copy_(torch.from_numpy(rng.normal(0, 0.1, leaf.shape)))
    _put(out, "moe/params", mp)
    return out


# ---------------------------------------------------------------------------
# the reference, on four virtual devices in a subprocess
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
from repro.train import steps
import test_torch_ranks as T
import test_torch_ranks_train as R

layers.DEFAULT_DTYPE = jnp.float32
adamw.update.__defaults__ = (jnp.float32,)
inp = dict(np.load(sys.argv[1]))
out = {}
devices = np.array(jax.devices()[:4])

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

def runtime(mesh_def, mode):
    _, shape, dp_axes = mesh_def
    n = int(np.prod(list(shape.values())))
    mesh = Mesh(devices[:n].reshape(tuple(shape.values())), tuple(shape))
    # no remat: the same values, less to compile
    return Runtime(mesh=mesh, dp_axes=dp_axes, gradsync=mode, remat="none")

def train(mesh_def, mode, cfg, params, batches):
    rt = runtime(mesh_def, mode)
    prefix = f"{mesh_def[0]}/{mode}"
    step = jax.jit(steps.make_train_step(registry.Arch(cfg), rt))
    # one placement for every call's inputs: one compile a step function
    rep = lambda tree: jax.device_put(tree, NamedSharding(rt.mesh, P()))
    p, o = rep((params, adamw.init(params)))
    for i, t in enumerate(batches):
        p, o, m = step(p, o, {"tokens": rep(jnp.asarray(t))})
        p, o = rep((p, o))
        out[f"{prefix}/loss{i}"] = np.asarray(m["loss"])
    put(f"{prefix}/params", p)
    put(f"{prefix}/master", o["master"])

def grads(mesh_def):
    rt = runtime(mesh_def, "gspmd")
    assert rt.moe_ep_size() == 2
    g = jax.jit(jax.grad(lambda p, t: transformer.lm_loss(
        p, mcfg, {"tokens": t}, rt)))(mp, jnp.asarray(mb[0]))
    put(f"{mesh_def[0]}/grads", g)

mcfg, dcfg = T._moe_cfg(), ModelConfig(**T.DENSE)
mp = jax.tree.map(jnp.asarray, T._nest(inp, "moe/params"))
dp = jax.tree.map(jnp.asarray, T._nest(inp, "dense/params"))
mb = R._batches(mcfg, R.MOE_SEQ, 70)
db = R._batches(dcfg, R.DENSE_SEQ, 80)
part = int(sys.argv[3])
if part == 0:
    # the experts split over "model" under gspmd, and the first gradient
    for mesh_def in (R.EP12, R.EP22):
        grads(mesh_def)
        train(mesh_def, "gspmd", mcfg, mp, mb)
    train(R.EP12, "spindle", mcfg, mp, mb)
elif part == 1:
    # two data axes, the dense model, every mode; a model axis
    for mode in R.ALL_MODES:
        train(R.POD, mode, dcfg, dp, db)
    for mode in R.MODES[1:]:
        train(R.EP12, mode, mcfg, mp, mb)
else:
    # three axes: the Spindle modes without expert parallelism, and gspmd
    for mode in R.ALL_MODES:
        train(R.PDM, mode, mcfg, mp, mb)
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""
REFERENCE_PARTS = 3


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs on disk, and the reference started on them in the
    background in REFERENCE_PARTS processes (each compiles a third of the
    step functions), stopped at the module's end."""
    d = tmp_path_factory.mktemp("ranks_train")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(d / "inputs.npz"),
         str(d / f"reference{i}.npz"), str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for i in range(REFERENCE_PARTS)]
    yield {"dir": d, "path": str(d / "inputs.npz"), "procs": procs,
           "arrays": dict(np.load(d / "inputs.npz"))}
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference(inputs):
    out = {}
    for i, proc in enumerate(inputs["procs"]):
        try:
            stdout, stderr = proc.communicate(timeout=REFERENCE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, stdout + stderr
        assert "REFERENCE-OK" in stdout
        out.update(np.load(inputs["dir"] / f"reference{i}.npz"))
    return out


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _own_rows(t, axis):
    if axis is None:
        return torch.from_numpy(t)
    rows = t.shape[0] // axis.size
    return torch.from_numpy(t[axis.index * rows:(axis.index + 1) * rows])


def _train(mesh, dp_axes, mode, cfg, host, batches):
    """``make_train_step`` for STEPS steps on this rank's rows (its
    experts where the step splits them); the state comes back whole."""
    arch = registry.Arch(cfg)
    rt = Runtime(gradsync=mode, mesh=mesh, dp_axes=dp_axes)
    params = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    experts = mesh.axis("model") if steps.splits_experts(arch, rt) else None
    if experts is not None:
        params = moe.shard_experts(params, experts.index, experts.size)
    axis = steps.batch_axis(arch, rt)
    step = steps.make_train_step(arch, rt, param_dtype=torch.float32,
                                 donate=True)
    opt = adamw.init(params)
    losses, norms = [], []
    for t in batches:
        params, opt, metrics = step(params, opt,
                                    {"tokens": _own_rows(t, axis)})
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    state = {"params": params, "opt": opt}
    if experts is not None:
        state = moe.gather_experts(state, experts)
    return {"losses": losses, "norms": norms, **state,
            "split": experts is not None}


def _ep_grads(mesh, cfg, host, batch):
    """The first step's gradients of the expert-parallel step: every leaf
    reduced over the data axes, the expert leaves this rank's rows."""
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh)
    experts = mesh.axis("model")
    params = moe.shard_experts(
        convert.params_from_numpy(host, cfg, "cpu", torch.float32),
        experts.index, experts.size)
    loss, grads, norm = steps.ep_rank_grads(arch, rt)(
        params, {"tokens": _own_rows(batch, steps.batch_axis(arch, rt))})
    return {"loss": loss, "grads": grads, "norm": norm,
            "model_index": experts.index}


def _trainer_run(mesh, directory, n_steps):
    tcfg = trainer.TrainConfig(steps=n_steps, seq_len=MOE_SEQ,
                               global_batch=ROWS, log_every=1,
                               checkpoint_every=2, checkpoint_dir=directory,
                               data_patterns=8, param_dtype=torch.float32)
    tr = trainer.Trainer(MOE_NAME, _moe_cfg(), tcfg,
                         Runtime(mesh=mesh), device=mesh.device)
    params, opt = tr.run()
    return tr, params, opt


def _trainer(mesh, workdir):
    tr, params, opt = _trainer_run(mesh, str(Path(workdir) / "unbroken"),
                                   TRAINER_STEPS)
    restart = str(Path(workdir) / "restart")
    _trainer_run(mesh, restart, 2)
    again, resumed, resumed_opt = _trainer_run(mesh, restart, TRAINER_STEPS)
    return {"history": tr.history, "writer": tr.writer,
            "experts_here": params["layers"]["moe"]["w_gate"].shape[1],
            "params": params, "opt": opt, "resumed": resumed,
            "resumed_opt": resumed_opt,
            "resumed_steps": [h["step"] for h in again.history],
            "dir": str(Path(workdir) / "unbroken")}


def _two_ranks(rank, device, inputs_path, workdir):
    inp = dict(np.load(inputs_path))
    mcfg = _moe_cfg()
    host = _nest(inp, "moe/params")
    mb = _batches(mcfg, MOE_SEQ, 70)
    name, shape, dp_axes = EP12
    mesh = ranks.RankMesh(shape, device)
    return {"ep_grads": _ep_grads(mesh, mcfg, host, mb[0]),
            "train": {mode: _train(mesh, dp_axes, mode, mcfg, host, mb)
                      for mode in ALL_MODES},
            "trainer": _trainer(mesh, workdir)}


def _mesh_checks(mesh):
    out = {}
    for names in (("pod", "data"), ("pod",), ("data",)):
        axis = mesh.axis(names)
        out[",".join(names)] = (axis.name, axis.index, axis.size)
    for bad in (("data", "pod"), ("pod", "model"), ("model",)):
        try:
            mesh.axis(bad)
            out[",".join(bad)] = None
        except KeyError as e:
            out[",".join(bad)] = str(e)
    # the product's group: the sum over it of every rank's number
    out["sum"] = float(ranks.all_reduce(
        torch.tensor(float(mesh.rank + 1)), mesh.axis(("pod", "data"))))
    return out


def _four_ranks(rank, device, inputs_path):
    inp = dict(np.load(inputs_path))
    mcfg, dcfg = _moe_cfg(), ModelConfig(**DENSE)
    mhost, dhost = _nest(inp, "moe/params"), _nest(inp, "dense/params")
    mb, db = _batches(mcfg, MOE_SEQ, 70), _batches(dcfg, DENSE_SEQ, 80)
    out = {}
    mesh = ranks.RankMesh(EP22[1], device)
    out["ep22"] = {"grads": _ep_grads(mesh, mcfg, mhost, mb[0]),
                   "gspmd": _train(mesh, EP22[2], "gspmd", mcfg, mhost, mb),
                   "coords": (mesh.axis("data").index,
                              mesh.axis("model").index)}
    mesh = ranks.RankMesh(POD[1], device)
    out["pod"] = {mode: _train(mesh, POD[2], mode, dcfg, dhost, db)
                  for mode in ALL_MODES}
    out["mesh"] = _mesh_checks(mesh)
    mesh = ranks.RankMesh(PDM[1], device)
    out["pdm"] = {mode: _train(mesh, PDM[2], mode, mcfg, mhost, mb)
                  for mode in ALL_MODES}
    return out


@pytest.fixture(scope="module")
def two(inputs):
    return ranks.spawn(_two_ranks, ["cpu", "cpu"], inputs["path"],
                       str(inputs["dir"]), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def four(inputs):
    return ranks.spawn(_four_ranks, ["cpu"] * 4, inputs["path"],
                       timeout=SPAWN_TIMEOUT)


# ---------------------------------------------------------------------------
# the one-rank runs the ranks are held to
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsplit(inputs):
    """The port's one-rank MoE step (no mesh): its first gradient, with
    every router's top-k gap, and 2 steps."""
    cfg = _moe_cfg()
    arch = registry.Arch(cfg)
    host = _nest(inputs["arrays"], "moe/params")
    mb = _batches(cfg, MOE_SEQ, 70)
    params = convert.params_from_numpy(host, cfg, "cpu", torch.float32)
    gaps, route = [], moe.route

    def recording(p, c, x):
        with torch.no_grad():
            probs = torch.softmax(moe.router_logits(p, x), -1)
            top = torch.sort(probs, -1, descending=True).values
            k = c.moe.top_k
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
        return route(p, c, x)

    moe.route = recording
    try:
        loss, grads = steps.value_and_grad(arch, Runtime())(
            params, {"tokens": torch.from_numpy(mb[0])})
    finally:
        moe.route = route
    step = steps.make_train_step(arch, Runtime(), param_dtype=torch.float32,
                                 donate=True)
    opt = adamw.init(params)
    losses = []
    for t in mb:
        params, opt, metrics = step(params, opt,
                                    {"tokens": torch.from_numpy(t)})
        losses.append(metrics["loss"])
    return {"loss": loss, "grads": grads, "gap": min(gaps),
            "losses": losses, "params": params, "opt": opt}


def _unsplit_trainer(directory):
    tcfg = trainer.TrainConfig(steps=TRAINER_STEPS, seq_len=MOE_SEQ,
                               global_batch=ROWS, log_every=1,
                               checkpoint_every=2, checkpoint_dir=directory,
                               data_patterns=8, param_dtype=torch.float32)
    tr = trainer.Trainer(MOE_NAME, _moe_cfg(), tcfg, Runtime(),
                         device="cpu")
    params, _ = tr.run()
    return tr, params


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _equal_trees(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(tree_util.paths(a), lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def _ref_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _close_to_reference(got, reference, prefix):
    """Losses, parameters and the AdamW master of one run at 2e-5."""
    for i, loss in enumerate(got["losses"]):
        np.testing.assert_allclose(float(loss),
                                   float(reference[f"{prefix}/loss{i}"]),
                                   rtol=RTOL, err_msg=f"{prefix} loss{i}")
    for name, tree in (("params", got["params"]),
                       ("master", got["opt"]["master"])):
        want = _nest(reference, f"{prefix}/{name}")
        for path, leaf in tree_util.paths(tree):
            np.testing.assert_allclose(
                leaf.numpy(), _ref_leaf(want, path), rtol=RTOL, atol=ATOL,
                err_msg=f"{prefix}/{name}/{path}")


def _grads_close(got, want, index, size):
    """Every leaf at 2e-5, an expert leaf against rows [index E/size,
    (index + 1) E/size) of the whole gradient."""
    for path, leaf in tree_util.paths(got):
        full = want(path)
        if moe.is_expert_leaf(path):
            n = leaf.shape[1]
            assert n * size == full.shape[1], path
            full = full[:, index * n:(index + 1) * n]
        np.testing.assert_allclose(leaf.numpy(), full, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def _all_ranks_identical(results, key):
    for other in results[1:]:
        _equal_trees(key(other), key(results[0]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_router_gaps_stay_clear_of_ties(unsplit):
    """The seeds give no near tie in any router's top-k, so a float32
    difference of summation order cannot change a route."""
    assert unsplit["gap"] > TIE_GAP


def test_ep_gradient_at_one_data_shard_is_the_unsplit_gradient(two,
                                                                unsplit):
    """``{"data": 1, "model": 2}``: the router's gradient (its partial
    part through the combine weights summed over the ranks, its aux part
    whole on each) and every other leaf equal the one-rank gradient;
    rank i holds rows [i E/2, (i + 1) E/2) of the expert leaves."""
    want = dict(tree_util.paths(unsplit["grads"]))
    for r in two:
        got = r["ep_grads"]
        np.testing.assert_allclose(float(got["loss"]),
                                   float(unsplit["loss"]), rtol=RTOL)
        _grads_close(got["grads"], lambda p: want[p].numpy(),
                     got["model_index"], 2)
        np.testing.assert_allclose(
            float(got["norm"]),
            float(adamw.global_norm(unsplit["grads"])), rtol=RTOL)


def test_ep_gradient_at_one_data_shard_matches_the_reference(two,
                                                             reference):
    want = _nest(reference, "ep12/grads")
    for r in two:
        got = r["ep_grads"]
        _grads_close(got["grads"], lambda p: _ref_leaf(want, p),
                     got["model_index"], 2)


def test_ep_train_step_at_one_data_shard_matches_reference_and_unsplit(
        two, reference, unsplit):
    for r in two:
        got = r["train"]["gspmd"]
        assert got["split"]
        _close_to_reference(got, reference, "ep12/gspmd")
        for a, b in zip(got["losses"], unsplit["losses"]):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
        for key in ("params", "opt"):
            for (path, x), y in zip(tree_util.paths(got[key]),
                                    tree_util.leaves(unsplit[key])):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=path)


def test_ep_train_step_keeps_the_ranks_identical(two, four):
    """The non-expert state is the same on every rank of the expert
    axis, and the gathered experts too: the whole state, bit for bit."""
    _all_ranks_identical(two, lambda r: r["train"]["gspmd"])
    _all_ranks_identical(four, lambda r: r["ep22"]["gspmd"])


def test_ep_gradient_at_two_data_shards_matches_the_reference(four,
                                                              reference):
    """``{"data": 2, "model": 2}``: every leaf of the first gradient, the
    mean over the data shards (the expert leaves never reduced over
    ``"model"``), against the reference's (2, 2) mesh."""
    want = _nest(reference, "ep22/grads")
    for r in four:
        got = r["ep22"]["grads"]
        _grads_close(got["grads"], lambda p: _ref_leaf(want, p),
                     got["model_index"], 2)


def test_ep_reported_loss_is_the_mean_ce_plus_shard_zeros_aux(four,
                                                              reference):
    """The reference's property at more than one data shard: the loss it
    reports is the cross-entropy mean plus data shard 0's aux loss (its
    ``shard_map`` returns shard 0's ``P()`` output), while its gradient
    is that of the cross-entropy mean plus the mean of the shards' aux
    losses (the test above).  The port reports the same loss on every
    rank, and trains to the reference's state."""
    coords = sorted(r["ep22"]["coords"] for r in four)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four:
        _close_to_reference(r["ep22"]["gspmd"], reference, "ep22/gspmd")
    _all_ranks_identical(four, lambda r: r["ep22"]["grads"]["loss"])


@pytest.mark.parametrize("mode", ALL_MODES)
def test_two_data_axes_match_the_reference(four, reference, mode):
    """``{"pod": 2, "data": 2}`` with ``dp_axes=("pod", "data")``: the
    compressed mode's int8 leg over ``"data"`` then a plain mean over
    ``"pod"``, the others over the product; every rank the same bits."""
    _all_ranks_identical(four, lambda r: r["pod"][mode])
    _close_to_reference(four[0]["pod"][mode], reference, f"pod/{mode}")


@pytest.mark.parametrize("mode", MODES)
def test_spindle_modes_on_a_model_axis_match_the_reference(two, reference,
                                                           mode):
    """``{"data": 1, "model": 2}``: the Spindle modes hold every expert
    on every rank (the reference's manual region runs without its
    mesh), so the two ranks compute the same thing."""
    assert not two[0]["train"][mode]["split"]
    _all_ranks_identical(two, lambda r: r["train"][mode])
    _close_to_reference(two[0]["train"][mode], reference, f"ep12/{mode}")


@pytest.mark.parametrize("mode", ALL_MODES)
def test_three_axes_match_the_reference(four, reference, mode):
    """``{"pod": 2, "data": 1, "model": 2}``: the Spindle modes without
    expert parallelism, ``gspmd`` with the experts split and its tokens
    over ``("pod", "data")``; every rank the same bits."""
    assert four[0]["pdm"][mode]["split"] == (mode == "gspmd")
    _all_ranks_identical(four, lambda r: r["pdm"][mode])
    _close_to_reference(four[0]["pdm"][mode], reference, f"pdm/{mode}")


def test_spindle_and_gspmd_report_different_losses_on_three_axes(four):
    """The reference's Spindle modes average each pod's whole loss (its
    own aux included); ``gspmd`` reports the cross-entropy mean plus
    shard 0's aux: the losses differ."""
    pdm = four[0]["pdm"]
    assert float(pdm["spindle"]["losses"][0]) != \
        float(pdm["gspmd"]["losses"][0])


def test_trainer_over_an_expert_mesh_matches_the_unsplit_trainer(
        two, tmp_path):
    tr, params = _unsplit_trainer(str(tmp_path / "unsplit"))
    for r in two:
        got = r["trainer"]
        assert got["experts_here"] == 4
        assert len(got["history"]) == len(tr.history) == TRAINER_STEPS
        for h, w in zip(got["history"], tr.history):
            assert h["step"] == w["step"] and h["lr"] == w["lr"]
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(h[k], w[k], rtol=RTOL, err_msg=k)


def test_trainer_rank_zero_writes_the_whole_experts(two, tmp_path):
    """Rank 0's checkpoint holds the whole tree in the reference's
    layout, equal to the unsplit run's; the other rank writes none."""
    _, params = _unsplit_trainer(str(tmp_path / "unsplit"))
    zero, one = (r["trainer"] for r in two)
    assert zero["writer"] and not one["writer"]
    like = {"params": params, "opt": adamw.init(params)}
    step, tree, extra = checkpoint.restore(zero["dir"], like)
    assert step == TRAINER_STEPS and extra == {"arch": _moe_cfg().name}
    assert tree["params"]["layers"]["moe"]["w_gate"].shape == \
        params["layers"]["moe"]["w_gate"].shape
    for (path, x), y in zip(tree_util.paths(tree["params"]),
                            tree_util.leaves(params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_trainer_over_an_expert_mesh_restarts_bit_identically(two):
    for r in two:
        got = r["trainer"]
        assert got["resumed_steps"] == [3, 4]
        _equal_trees(got["resumed"], got["params"])
        _equal_trees(got["resumed_opt"], got["opt"])


def test_rank_mesh_product_axes(four):
    """``("pod", "data")``: index row-major over the named axes, size the
    product; a one-name tuple is that axis; a tuple out of mesh order or
    naming an axis the mesh lacks raises ``KeyError``."""
    for rank, r in enumerate(four):
        chk = r["mesh"]
        pod, data = divmod(rank, 2)
        assert chk["pod,data"] == (("pod", "data"), 2 * pod + data, 4)
        assert chk["pod"] == ("pod", pod, 2)
        assert chk["data"] == ("data", data, 2)
        for bad in ("data,pod", "pod,model", "model"):
            assert chk[bad] is not None and "no mesh axis" in chk[bad]
        assert chk["sum"] == 10.0
