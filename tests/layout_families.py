"""What ``tests/test_torch_family_layouts_recurrent.py`` (the ssm and
hybrid families), ``tests/test_torch_family_layouts.py`` (the moe, vlm
and encdec families) and ``tests/test_torch_seq_parallel.py`` (every
family under the sequence-parallel presets) share: the tiny configs and
their cases, the inputs drawn from seeds, the reference's GSPMD steps on
four virtual devices (a script run in one subprocess a case), what each
rank runs, and the comparisons.

A case is a config under a preset on a mesh: ``baseline`` on ``{"data":
2, "model": 2}`` (FSDP and tensor parallelism), ``megatron`` on
``{"model": 2}`` (tensor parallelism alone) and on ``{"data": 1,
"model": 4}`` (a dim that does not divide 4 ranks stays whole: the
hybrid's 2 kv heads, the encdec's vocabulary of 258); ``seq_model`` and
``megatron_seq`` likewise, the sequence split over ``"model"`` between
the mixers.  Every case trains 2 steps and counts its collectives
against the dry-run's; the ``megatron`` and ``megatron_seq`` cases also
serve (greedy decode against the reference, a ``ServeEngine`` against
the unsplit engine), the ``baseline`` cases run a ``Trainer`` with a
restart.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core import ranks
from repro_torch.launch import dryrun
from repro_torch.models import config as config_lib
from repro_torch.models import convert, layers, registry
from repro_torch.models.config import ShapeConfig
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.train import checkpoint, rules, steps, trainer
from test_torch_ranks import DENSE, _nest, _put

ROOT = Path(__file__).resolve().parent.parent
_SSM = dict(d_state=16, head_dim=16, expand=2, chunk=8)
# name -> (ModelConfig fields, sub-configs); width 64 throughout.  The
# ssm's fused projection has 296 columns (z 128, x 128, B, C 16 each, dt
# 8): over 2 ranks the block edge falls inside x, over 4 inside z, as
# mamba2-2.7b's does over 2 (5288 of 10576, inside x)
CONFIGS = {
    "ssm": (dict(family="ssm", n_layers=2, d_model=64, n_heads=1,
                 n_kv_heads=1, d_ff=0, vocab_size=256, head_dim=16),
            {"ssm": _SSM}),
    "ssm-g2": (dict(family="ssm", n_layers=2, d_model=64, n_heads=1,
                    n_kv_heads=1, d_ff=0, vocab_size=256, head_dim=16),
               {"ssm": dict(_SSM, n_groups=2)}),
    "hybrid": (dict(family="hybrid", n_layers=4, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
                    rope_theta=1e4),
               {"ssm": _SSM, "hybrid": dict(attn_every=2)}),
    "moe": (dict(family="moe", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
                 qkv_bias=True, rope_theta=1e6),
            {"moe": dict(n_routed=4, top_k=2, n_shared=1, d_ff_expert=32)}),
    "vlm": (dict(family="vlm", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
                 rope_theta=1e6),
            {"vlm": dict(n_patches=4, vision_dim=32)}),
    "encdec": (dict(family="encdec", n_layers=4, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=128, vocab_size=258, head_dim=16,
                    rope_theta=1e4),
               {"encdec": dict(n_encoder_layers=2, n_decoder_layers=2)}),
    # the dense test config (qk-norm, tied embeddings) and a qwen2-like
    # one (QKV bias, an untied head), as tests/test_torch_rules_ranks.py's
    "dense": ({k: v for k, v in DENSE.items() if k != "name"}, {}),
    "qwen2": (dict({k: v for k, v in DENSE.items() if k != "name"},
                   qkv_bias=True, qk_norm=False, tie_embeddings=False), {}),
}
SUB = {"ssm": "SSMConfig", "hybrid": "HybridConfig", "moe": "MoEConfig",
       "vlm": "VLMConfig", "encdec": "EncDecConfig"}
BL22 = ({"data": 2, "model": 2}, "baseline")
MG2 = ({"model": 2}, "megatron")
MG14 = ({"data": 1, "model": 4}, "megatron")
SM22 = ({"data": 2, "model": 2}, "seq_model")
MS2 = ({"model": 2}, "megatron_seq")
MS14 = ({"data": 1, "model": 4}, "megatron_seq")
SS22 = ({"data": 2, "model": 2}, "ssm_seq")
SS2 = ({"model": 2}, "ssm_seq")
SS14 = ({"data": 1, "model": 4}, "ssm_seq")
# case -> (config, mesh shape, preset)
CASES = {"ssm_bl22": ("ssm", *BL22), "ssm_mg2": ("ssm-g2", *MG2),
         "hyb_bl22": ("hybrid", *BL22), "hyb_mg2": ("hybrid", *MG2),
         "hyb_mg14": ("hybrid", *MG14),
         "moe_bl22": ("moe", *BL22), "moe_mg2": ("moe", *MG2),
         "vlm_bl22": ("vlm", *BL22), "vlm_mg2": ("vlm", *MG2),
         "enc_bl22": ("encdec", *BL22), "enc_mg2": ("encdec", *MG2),
         "enc_mg14": ("encdec", *MG14),
         "dense_sm22": ("dense", *SM22), "qwen2_ms14": ("qwen2", *MS14),
         "moe_sm22": ("moe", *SM22), "vlm_ms2": ("vlm", *MS2),
         "enc_ms14": ("encdec", *MS14), "ssm_sm22": ("ssm", *SM22),
         "hyb_ms14": ("hybrid", *MS14),
         "ssm_ss22": ("ssm", *SS22), "hyb_ss14": ("hybrid", *SS14),
         "dense_ss2": ("dense", *SS2), "moe_ss22": ("moe", *SS22),
         "vlm_ss2": ("vlm", *SS2), "enc_ss14": ("encdec", *SS14)}
RECURRENT = ("ssm_bl22", "ssm_mg2", "hyb_bl22", "hyb_mg2", "hyb_mg14")
FAMILIES = ("moe_bl22", "moe_mg2", "vlm_bl22", "vlm_mg2", "enc_bl22",
            "enc_mg2", "enc_mg14")
SEQ_PARALLEL = ("dense_sm22", "qwen2_ms14", "moe_sm22", "vlm_ms2",
                "enc_ms14", "ssm_sm22", "hyb_ms14")
SSM_SEQ = ("ssm_ss22", "hyb_ss14", "dense_ss2", "moe_ss22", "vlm_ss2",
           "enc_ss14")
# the tokens a training row of the recurrent ssm_seq cases: two chunks a
# rank over 2 ranks, one over 4 (a fold over four ranks)
SSM_SEQ_LEN = 32
DRAWS = {"bq": (0, 0.1), "bk": (0, 0.1), "bv": (0, 0.1),
         "conv_b": (0, 0.1), "a_log": (0, 0.5), "dt_bias": (0, 0.5),
         "d_skip": (1, 0.3)}
ROWS, SEQ, STEPS, S_SRC = 4, 16, 2, 8
PROMPT_ROWS, PROMPT, DECODE, S_MAX = 2, 8, 3, 16
TRAINER_STEPS = 4
ATOL = RTOL = 2e-5
SPAWN_TIMEOUT = 400.0
REFERENCE_TIMEOUT = 400.0


def build(config: str, module=config_lib):
    """``config``'s ModelConfig from ``module`` (the port's config module
    or the reference's)."""
    base, subs = CONFIGS[config]
    return module.ModelConfig(
        name=f"layout-{config}", **base,
        **{k: getattr(module, SUB[k])(**v) for k, v in subs.items()})


def cfg_of(case: str):
    return build(CASES[case][0])


def mesh_shape(case: str):
    return CASES[case][1]


def table(case: str):
    return rules.get(CASES[case][2], cfg_of(case))


def served(case: str) -> bool:
    """The cases that serve: ``megatron`` and ``megatron_seq``, and
    ``ssm_seq`` on one data rank."""
    preset = CASES[case][2]
    return preset in ("megatron", "megatron_seq") or (
        preset == "ssm_seq" and mesh_shape(case).get("data", 1) == 1)


def trained(case: str) -> bool:
    """The cases that run a ``Trainer``: every ``baseline`` case, and the
    MoE's on ``{"model": 2}``, whose Trainer is the unsplit one's."""
    return CASES[case][2] == "baseline" or case == "moe_mg2"


def as_unsplit(case: str) -> bool:
    """Whether the case's steps are the unsplit steps' function: all but
    an MoE over more than one data shard, whose capacity and aux loss
    come from each shard's tokens (the reference's ``shard_map``)."""
    return cfg_of(case).family != "moe" or \
        mesh_shape(case).get("data", 1) == 1


def kv_prefill(case: str) -> bool:
    """Whether the case's serving starts from a prefill that fills a KV
    cache (the dense, moe and vlm families), else from a zero decode
    state fed the prompt token by token (the recurrent families and the
    encdec, whose prefill is its encoder)."""
    return cfg_of(case).family in ("dense", "moe", "vlm")


def seq_len(case: str) -> int:
    """The tokens a training row: SEQ, and one more for the encdec under
    a sequence-parallel preset, so that its decoder's SEQ positions
    (``tokens[:, :-1]``) split as its encoder's frames do;
    :data:`SSM_SEQ_LEN` for the Mamba stacks under ``ssm_seq``, whose
    rows hold whole chunks."""
    if cfg_of(case).family == "encdec" and CASES[case][2].endswith("seq"):
        return SEQ + 1
    if cfg_of(case).ssm is not None and CASES[case][2] == "ssm_seq":
        return SSM_SEQ_LEN
    return SEQ


def _draw(config: str, seed: int):
    params = registry.Arch(build(config)).init_params(seed, "cpu",
                                                      torch.float32)
    rng = np.random.default_rng(seed + 100)
    for path, leaf in tree_util.paths(params):
        key = path.split("/")[-1]
        if key in DRAWS:
            mu, sd = DRAWS[key]
            leaf.copy_(torch.from_numpy(rng.normal(mu, sd, leaf.shape)))
    return params


def inputs(cases, seeds=None):
    """The parameters of every config of ``cases`` (the port's
    initialisation, the biases and the ssm's per-head vectors drawn: a
    zero or one init hides bugs; config -> seed from ``seeds``, else 40
    on in sorted order) and each served encdec case's cross cache, drawn
    from seeds, as flat numpy arrays."""
    out = {}
    for i, config in enumerate(sorted({CASES[c][0] for c in cases})):
        seed = 40 + i if seeds is None else seeds[config]
        _put(out, f"{config}/params", _draw(config, seed))
    for case in cases:
        cfg = cfg_of(case)
        if served(case) and cfg.family == "encdec":
            rng = np.random.default_rng(60)
            shape = (cfg.encdec.n_decoder_layers, PROMPT_ROWS, S_SRC,
                     cfg.n_kv_heads, cfg.head_dim_)
            for k in ("cross_k", "cross_v"):
                out[f"{case}/{k}"] = rng.normal(size=shape).astype(
                    np.float32)
    return out


def batch(case: str, step: int, rows: int = ROWS, seq: int = None):
    """A numpy batch of the family's inputs: tokens (:func:`seq_len` a
    row unless ``seq`` says), and the vlm's patches or the encdec's
    frames."""
    cfg = cfg_of(case)
    seq = seq_len(case) if seq is None else seq
    rng = np.random.default_rng(90 + 7 * step + len(case))
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(rows, seq),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(rows, cfg.vlm.n_patches,
                                          cfg.vlm.vision_dim)
                                    ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(rows, S_SRC, cfg.d_model)
                                   ).astype(np.float32)
    return out


def prompt(case: str):
    return batch(case, 50, PROMPT_ROWS, PROMPT)


# ---------------------------------------------------------------------------
# the reference, on four virtual devices in subprocesses
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs  # noqa: F401  (registers archs)
from repro.models import config as config_lib
from repro.models import layers, registry
from repro.models.config import ShapeConfig
from repro.models.runtime import Runtime
from repro.optim import adamw
from repro.train import rules as rules_lib, steps
import test_torch_ranks as T
import layout_families as L

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
config, shape, preset = L.CASES[name]
cfg = L.build(config, config_lib)
arch = registry.Arch(cfg)
n = int(np.prod(list(shape.values())))
mesh = Mesh(devices[:n].reshape(tuple(shape.values())), tuple(shape))
rules = rules_lib.get(preset, cfg)
# no remat: the same values, less to compile
rt = Runtime(mesh=mesh, rules=rules, remat="none")
shardings = layers.tree_shardings(arch.param_specs(), rules, mesh)
rep = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
jb = lambda b: rep({k: jnp.asarray(v) for k, v in b.items()})
opt_shardings = {"step": NamedSharding(mesh, P()), "master": shardings,
                 "m": shardings, "v": shardings}
params = jax.device_put(jax.tree.map(jnp.asarray, T._nest(
    inp, f"{config}/params")), shardings)
batches = [L.batch(name, i) for i in range(L.STEPS)]
loss_fn = arch.loss_fn()
grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, cfg, b, rt)))(
    params, jb(batches[0]))
put(f"{name}/grads", grads)
step = jax.jit(steps.make_train_step(arch, rt))
p, o = params, jax.device_put(adamw.init(params), opt_shardings)
for i, b in enumerate(batches):
    p, o, m = step(p, o, jb(b))
    # one placement for every call's inputs: one compile
    p, o = jax.device_put(p, shardings), jax.device_put(o, opt_shardings)
    out[f"{name}/loss{i}"] = np.asarray(m["loss"])
put(f"{name}/params", p)
put(f"{name}/master", o["master"])
if L.served(name):
    decode = jax.jit(steps.make_serve_step(arch, rt, "decode"))
    prompt = L.prompt(name)
    if L.kv_prefill(name):
        prefill = jax.jit(steps.make_serve_step(arch, rt, "prefill"))
        logits, cache = prefill(params, jb(prompt))
        pos = cache["k"].shape[2]
        pad = [(0, 0), (0, 0), (0, L.S_MAX - pos), (0, 0), (0, 0)]
        cache = {k: jnp.pad(v, pad) for k, v in cache.items()}
        feed = []
    else:
        specs = arch.cache_specs(ShapeConfig("x", L.S_MAX, L.PROMPT_ROWS,
                                             "decode"))
        cache = {k: jnp.zeros(s.shape, jnp.float32) for k, s in
                 specs.items()}
        if cfg.family == "encdec":
            memory, _ = arch.prefill_fn()(params, jb(prompt), rt)
            out[f"{name}/memory"] = np.asarray(memory)
            for k in ("cross_k", "cross_v"):
                cache[k] = jnp.asarray(inp[f"{name}/{k}"])
        pos, feed = 0, [prompt["tokens"][:, i:i + 1]
                        for i in range(L.PROMPT)]
    for t in feed:
        logits, cache = decode(params, rep(cache), {"tokens": rep(
            jnp.asarray(t))}, rep(jnp.int32(pos)))
        pos += 1
    for i in range(L.DECODE + 1):
        out[f"{name}/logits{i}"] = np.asarray(logits)
        if i == L.DECODE:
            break
        nxt = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))[:, None]
        out[f"{name}/fed{i}"] = nxt
        logits, cache = decode(params, rep(cache), {"tokens": rep(
            jnp.asarray(nxt))}, rep(jnp.int32(pos)))
        pos += 1
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""


def start_reference(directory: Path, cases):
    """The reference started on the inputs in the background, one process
    a case: ``{case: Popen}``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    return {case: subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(directory / "inputs.npz"),
         str(directory / f"reference_{case}.npz"), case],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for case in cases}


def stop(procs) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def collect(directory: Path, procs):
    out = {}
    for case, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=REFERENCE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, stdout + stderr
        assert "REFERENCE-OK" in stdout
        out.update(np.load(directory / f"reference_{case}.npz"))
    return out


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def register(case: str):
    cfg = cfg_of(case)
    registry.register(cfg.name, lambda: cfg)
    return cfg


def _rows(b, axis):
    """This rank's rows of every leaf of the numpy batch ``b``."""
    out = {}
    for k, v in b.items():
        if axis is not None:
            n = v.shape[0] // axis.size
            v = v[axis.index * n:(axis.index + 1) * n]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _coords(mesh):
    return {a: mesh.axis(a).index for a in mesh.shape}


def _laid_out(case, mesh, host, dtype=torch.float32, remat="none"):
    cfg = cfg_of(case)
    arch = registry.Arch(cfg)
    rt = Runtime(mesh=mesh, rules=table(case), remat=remat)
    params = layers.shard_params(
        convert.params_from_numpy(host, cfg, "cpu", dtype),
        arch.param_specs(), rt.rules_(), mesh)
    return arch, rt, params


def train_case(case, mesh, host):
    """The first step's gradient blocks and STEPS steps of
    ``make_train_step`` on this rank's rows and blocks; the state comes
    back whole, beside this rank's block shapes."""
    arch, rt, params = _laid_out(case, mesh, host)
    axis = steps.batch_axis(arch, rt)
    out = {"split": steps.splits_layout(arch, rt), "coords": _coords(mesh),
           "shapes": {p: tuple(x.shape) for p, x in tree_util.paths(params)}}
    loss, grads, norm = steps.layout_rank_grads(arch, rt)(
        params, _rows(batch(case, 0), axis))
    out.update(grad_loss=loss, grads=grads, norm=norm)
    step = steps.make_train_step(arch, rt, param_dtype=torch.float32,
                                 donate=True)
    opt = adamw.init(params)
    losses = []
    for i in range(STEPS):
        params, opt, metrics = step(params, opt, _rows(batch(case, i), axis))
        losses.append(metrics["loss"])
    state = layers.gather_params({"params": params, "opt": opt},
                                 arch.param_specs(), rt.rules_(), mesh)
    return {**out, "losses": losses, **state}


def rank_kv(whole: torch.Tensor, cfg, axis) -> torch.Tensor:
    """This rank's kv heads (dim 3) of a whole (L, B, S, Hkv, D) cache:
    its share where they split, else the one its q heads read."""
    if axis is None or cfg.n_heads % axis.size:
        return whole
    if cfg.n_kv_heads % axis.size == 0:
        n = cfg.n_kv_heads // axis.size
        return whole.narrow(3, axis.index * n, n)
    first = axis.index * (cfg.n_heads // axis.size) // (
        cfg.n_heads // cfg.n_kv_heads)
    return whole.narrow(3, first, 1)


def serve_case(case, mesh, host, inp):
    """Greedy decode through ``make_serve_step`` on this rank's blocks
    (after a prefill, or from a zero state fed the prompt), the logits
    gathered whole; and a ``ServeEngine`` of three requests."""
    cfg = register(case)
    arch, rt, params = _laid_out(case, mesh, host)
    decode = steps.make_serve_step(arch, rt, "decode")
    pr = prompt(case)
    out = {}
    with torch.no_grad():
        if kv_prefill(case):
            logits, cache = steps.make_serve_step(arch, rt, "prefill")(
                params, _rows(pr, None))
            pos = cache["k"].shape[2]
            pad = (0, 0, 0, 0, 0, S_MAX - pos)
            cache = {k: torch.nn.functional.pad(v, pad)
                     for k, v in cache.items()}
            feed = []
        else:
            specs = arch.cache_specs(ShapeConfig("x", S_MAX, PROMPT_ROWS,
                                                 "decode"),
                                     tp=registry.tp_ways(cfg, rt))
            cache = layers.map_specs(lambda s: torch.zeros(
                s.shape, dtype=s.dtype_for(torch.float32)), specs)
            if cfg.family == "encdec":
                out["memory"], _ = arch.prefill_fn()(params, _rows(pr, None),
                                                     rt)
                axis = rt.tp_axis() if registry.tp_ways(cfg, rt) > 1 \
                    else None
                for k in ("cross_k", "cross_v"):
                    cache[k] = rank_kv(torch.from_numpy(inp[f"{case}/{k}"]),
                                       cfg, axis)
            pos, feed = 0, [torch.from_numpy(pr["tokens"][:, i:i + 1])
                            for i in range(PROMPT)]
        out["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}

        def step(tokens):
            nonlocal pos, cache
            at = torch.full((PROMPT_ROWS,), pos, dtype=torch.int32)
            logits, cache = decode(params, cache, {"tokens": tokens}, at)
            pos += 1
            return logits

        for t in feed:
            logits = step(t)
        for i in range(DECODE + 1):
            out[f"logits{i}"] = logits
            if i == DECODE:
                break
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            out[f"fed{i}"] = nxt
            logits = step(nxt)
    out["engine"] = engine(case, params, rt)
    return out


def engine(case, params, rt):
    cfg = cfg_of(case)
    eng = ServeEngine(cfg.name, params, cfg,
                      EngineConfig(max_batch=2, max_len=S_MAX), rt=rt,
                      device="cpu")
    rng = np.random.default_rng(97)
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab_size, 4 + rid,
                                             dtype=np.int32),
                           max_new_tokens=3))
    done = eng.run_until_drained()
    return {"tokens": {r.rid: list(r.tokens_out) for r in done},
            "cache_shapes": {k: tuple(v.shape)
                             for k, v in eng.cache.items()}}


def trainer_run(case, mesh, directory, n_steps):
    cfg = register(case)
    tcfg = trainer.TrainConfig(steps=n_steps, seq_len=SEQ, global_batch=ROWS,
                               log_every=1, checkpoint_every=2,
                               checkpoint_dir=directory, data_patterns=8,
                               param_dtype=torch.float32)
    rt = Runtime() if mesh is None else Runtime(mesh=mesh,
                                                rules=table(case))
    tr = trainer.Trainer(cfg.name, cfg, tcfg, rt, device="cpu")
    params, opt = tr.run()
    return tr, params, opt


def trainer_case(case, mesh, workdir):
    base = Path(workdir) / case
    tr, params, opt = trainer_run(case, mesh, str(base / "unbroken"),
                                  TRAINER_STEPS)
    restart = str(base / "restart")
    trainer_run(case, mesh, restart, 2)
    again, resumed, resumed_opt = trainer_run(case, mesh, restart,
                                              TRAINER_STEPS)
    return {"history": tr.history, "writer": tr.writer, "split": tr.layout
            is not None, "whole": layers.gather_params(params, *tr.layout),
            "params": params, "opt": opt, "resumed": resumed,
            "resumed_opt": resumed_opt,
            "resumed_steps": [h["step"] for h in again.history],
            "dir": str(base / "unbroken")}


CELLS = {"train": ShapeConfig("layout-train", SEQ, ROWS, "train"),
         "prefill": ShapeConfig("layout-prefill", PROMPT, PROMPT_ROWS,
                                "prefill"),
         "decode": ShapeConfig("layout-decode", S_MAX, PROMPT_ROWS,
                               "decode")}


def cell(case: str, kind: str) -> ShapeConfig:
    """The dry-run cell ``CELLS[kind]`` a case's collectives are counted
    in: its train cell at :data:`SSM_SEQ_LEN` tokens a row for the Mamba
    stacks under ``ssm_seq`` (so that their rows split)."""
    if kind == "train" and seq_len(case) == SSM_SEQ_LEN:
        return ShapeConfig("layout-train", SSM_SEQ_LEN, ROWS, "train")
    return CELLS[kind]


def _cell_inputs(arch, shape, rows):
    """Random inputs of the dry-run cell ``shape``'s shapes, ``rows``
    rows of them."""
    gen = torch.Generator().manual_seed(5)
    out = {}
    for k, t in arch.input_specs(shape, batch_override=rows).items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, arch.cfg.vocab_size, t.shape,
                                   generator=gen, dtype=torch.int32)
        else:
            out[k] = torch.randn(t.shape, generator=gen).to(t.dtype)
    return out


def count_one(case, mesh, host, kind, remat):
    """The collectives this rank runs in one bfloat16 step of the dry-run
    cell ``CELLS[kind]`` (the first gradient and its reduction, a
    prefill, a decode step) on its rows: ``{(kind, operand bytes,
    group): count}``, an all-reduce's operand its tensor, a gather's and
    a reduce-scatter's their input, recorded where the collectives are
    called (``ranks._call``)."""
    arch, rt, params = _laid_out(case, mesh, host, torch.bfloat16, remat)
    shape = cell(case, kind)
    axis = steps.batch_axis(arch, rt)
    rows = shape.global_batch // (1 if axis is None else axis.size)
    inputs = _cell_inputs(arch, shape, rows)
    counts, call = {}, ranks._call

    def record(fn, *args, **kwargs):
        operand = args[0] if fn.__name__ == "all_reduce" else args[1]
        key = (ranks.KIND[fn.__name__],
               operand.numel() * operand.element_size(),
               dist.get_world_size(kwargs["group"]))
        counts[key] = counts.get(key, 0) + 1
        return call(fn, *args, **kwargs)

    ranks._call = record
    try:
        if kind == "train":
            steps.layout_rank_grads(arch, rt)(params, inputs)
        elif kind == "prefill":
            with torch.no_grad():
                steps.make_serve_step(arch, rt, "prefill")(params, inputs)
        else:
            cache = layers.map_specs(
                lambda s: torch.zeros(s.shape,
                                      dtype=s.dtype_for(torch.bfloat16)),
                arch.cache_specs(shape, batch_override=rows,
                                 tp=registry.tp_ways(arch.cfg, rt)))
            with torch.no_grad():
                steps.make_serve_step(arch, rt, "decode")(
                    params, cache, inputs, torch.zeros(rows,
                                                       dtype=torch.int32))
    finally:
        ranks._call = call
    return counts


def counts_case(case, mesh, host):
    return {f"{kind}/{remat}": count_one(case, mesh, host, kind, remat)
            for kind, remat in (("train", "none"), ("train", "full"),
                                ("prefill", "none"), ("decode", "none"))}


def run_ranks(rank, device, inputs_path, workdir, cases):
    """Every case of ``cases`` on this rank: its mesh, the train steps,
    the collectives' counts, and the serving or the Trainer."""
    inp = dict(np.load(inputs_path))
    out = {}
    for case in cases:
        mesh = ranks.RankMesh(mesh_shape(case), device)
        host = _nest(inp, f"{CASES[case][0]}/params")
        got = {"train": train_case(case, mesh, host),
               "counts": counts_case(case, mesh, host)}
        if served(case):
            got["serve"] = serve_case(case, mesh, host, inp)
        if trained(case):
            got["trainer"] = trainer_case(case, mesh, workdir)
        out[case] = got
    return out


def spawn_cases(cases, world, directory):
    """``run_ranks`` over the cases of ``cases`` on ``world`` ranks, in
    ``world`` gloo processes: ``{case: [rank 0's, rank 1's, ...]}``."""
    mine = [c for c in cases if
            int(np.prod(list(mesh_shape(c).values()))) == world]
    results = ranks.spawn(run_ranks, ["cpu"] * world,
                          str(directory / "inputs.npz"), str(directory),
                          mine, timeout=SPAWN_TIMEOUT)
    return {c: [r[c] for r in results] for c in mine}


def unsplit(cases, arrays, directory):
    """The port's one-rank runs the ranks are held to: each served case's
    engine and each trained case's Trainer."""
    out = {}
    for case in cases:
        cfg = register(case)
        if served(case):
            params = convert.params_from_numpy(
                _nest(arrays, f"{CASES[case][0]}/params"), cfg, "cpu",
                torch.float32)
            with torch.no_grad():
                out[f"{case}/engine"] = engine(case, params, Runtime())
        if trained(case) and as_unsplit(case):
            tr, params, _ = trainer_run(case, None,
                                        str(directory / f"unsplit_{case}"),
                                        TRAINER_STEPS)
            out[f"{case}/trainer"] = {"history": tr.history,
                                      "params": params}
    return out


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def stand_in(shape):
    return types.SimpleNamespace(
        shape=dict(shape), world_size=int(np.prod(list(shape.values()))),
        size=lambda a: shape.get(a, 1))


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
        index, size = 0, 1
        for a in layers.entry_axes(entry):
            index, size = index * shape[a] + coords[a], size * shape[a]
        n = whole.shape[dim] // size
        whole = np.take(whole, range(index * n, (index + 1) * n), axis=dim)
    return whole


def _layout(case):
    return layers.tree_layout(registry.param_specs(cfg_of(case)),
                              table(case), stand_in(mesh_shape(case)))


def check_blocks(case, results):
    """Each rank holds its block of every leaf: the shape of
    ``layers.shard_shape``."""
    specs = dict(layers.spec_paths(registry.param_specs(cfg_of(case))))
    for got in results:
        assert got["train"]["split"]
        for path, spec in specs.items():
            assert got["train"]["shapes"][path] == layers.shard_shape(
                spec, table(case), stand_in(mesh_shape(case))), path


def check_grads(case, results, reference):
    """The loss and every rank's block of every leaf of the first
    gradient against the same block of the reference's; the global norm
    against the whole gradient's."""
    want = _nest(reference, f"{case}/grads")
    layout = _layout(case)
    norm = np.sqrt(sum(float(np.sum(np.square(leaf.astype(np.float64))))
                       for leaf in tree_util.leaves(want)))
    for got in (r["train"] for r in results):
        np.testing.assert_allclose(float(got["grad_loss"]),
                                   float(reference[f"{case}/loss0"]),
                                   rtol=RTOL)
        for path, leaf in tree_util.paths(got["grads"]):
            block = _block(_ref_leaf(want, path), layout[path],
                           got["coords"], mesh_shape(case))
            np.testing.assert_allclose(leaf.numpy(), block, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{case}/{path}")
        np.testing.assert_allclose(float(got["norm"]), norm, rtol=RTOL)


def check_steps(case, results, reference):
    """The losses, and the parameters and AdamW master gathered whole."""
    for got in (r["train"] for r in results):
        for i, loss in enumerate(got["losses"]):
            np.testing.assert_allclose(float(loss),
                                       float(reference[f"{case}/loss{i}"]),
                                       rtol=RTOL, err_msg=f"{case} loss{i}")
        for key, tree in (("params", got["params"]),
                          ("master", got["opt"]["master"])):
            want = _nest(reference, f"{case}/{key}")
            for path, leaf in tree_util.paths(tree):
                np.testing.assert_allclose(
                    leaf.numpy(), _ref_leaf(want, path), rtol=RTOL,
                    atol=ATOL, err_msg=f"{case}/{key}/{path}")


def equal_trees(a, b):
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    assert len(la) == len(lb)
    for (path, x), y in zip(tree_util.paths(a), lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def check_same_bits(results):
    """Every rank's gathered state after the steps is the same, bit for
    bit: the blocks ranks share never diverge."""
    first = results[0]["train"]
    for other in (r["train"] for r in results[1:]):
        equal_trees({"p": other["params"], "o": other["opt"],
                     "l": other["losses"]},
                    {"p": first["params"], "o": first["opt"],
                     "l": first["losses"]})


def rank_cache_shapes(case, rows, max_len, src_len):
    """The decode state a rank holds: the whole cache's shapes (the
    cross cache of ``src_len`` positions) with a rank's kv heads, ssm
    heads and conv channels, counted here from the config; under
    ``ssm_seq``, whose heads stay whole, the whole cache's."""
    cfg = cfg_of(case)
    n = 1 if CASES[case][2] == "ssm_seq" else mesh_shape(case)["model"]
    whole = registry.cache_specs(cfg, ShapeConfig("x", max_len, rows,
                                                  "decode"))
    kv = cfg.n_kv_heads // n if cfg.n_kv_heads % n == 0 else 1
    out = {}
    for k, spec in whole.items():
        shape = list(spec.shape)
        if k in ("k", "v", "cross_k", "cross_v"):
            shape[-2] = kv if n > 1 else shape[-2]
            if k.startswith("cross"):
                shape[2] = src_len
        elif k == "ssm_state":
            shape[-3] //= n
        elif k == "conv_state":
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            groups = max(1, s.n_groups // n)
            shape[-1] = d_inner // n + 2 * groups * s.d_state
        out[k] = tuple(shape)
    return out


def check_serving(case, results, reference):
    """The greedy decode's logits at every step, gathered whole, against
    the reference's; the greedy tokens equal; the encdec's encoder
    memory; each rank's decode state its part."""
    for got in (r["serve"] for r in results):
        assert got["cache_shapes"] == rank_cache_shapes(
            case, PROMPT_ROWS, S_MAX, S_SRC)
        if "memory" in got:
            np.testing.assert_allclose(got["memory"].numpy(),
                                       reference[f"{case}/memory"],
                                       rtol=RTOL, atol=ATOL)
        for i in range(DECODE + 1):
            np.testing.assert_allclose(
                got[f"logits{i}"].numpy(), reference[f"{case}/logits{i}"],
                rtol=RTOL, atol=ATOL, err_msg=f"{case} logits{i}")
        for i in range(DECODE):
            assert np.array_equal(got[f"fed{i}"].numpy(),
                                  reference[f"{case}/fed{i}"]), i


def check_engine(case, results, unsplit_runs):
    """Each rank's engine, fed the same requests, emits the unsplit
    engine's tokens; its cache is this rank's part."""
    want = unsplit_runs[f"{case}/engine"]
    for got in (r["serve"]["engine"] for r in results):
        assert got["tokens"] == want["tokens"]
        assert got["cache_shapes"] == rank_cache_shapes(case, 2, S_MAX,
                                                        S_MAX)


def check_trainer_history(case, results, unsplit_runs):
    want = unsplit_runs[f"{case}/trainer"]["history"]
    for got in (r["trainer"] for r in results):
        assert got["split"]
        assert len(got["history"]) == len(want) == TRAINER_STEPS
        for h, w in zip(got["history"], want):
            assert h["step"] == w["step"] and h["lr"] == w["lr"]
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(h[k], w[k], rtol=RTOL, err_msg=k)


def check_trainer_checkpoint(case, results, unsplit_runs):
    """Rank 0 alone writes; its checkpoint holds the whole tree in the
    reference's layout: the ranks' state gathered whole, bit for bit,
    and within 2e-5 of the unsplit run's where the steps are its."""
    assert [r["trainer"]["writer"] for r in results] == \
        [True] + [False] * (len(results) - 1)
    mine = results[0]["trainer"]["whole"]
    like = {"params": mine, "opt": adamw.init(mine)}
    step, tree, _ = checkpoint.restore(results[0]["trainer"]["dir"], like)
    assert step == TRAINER_STEPS
    equal_trees(tree["params"], mine)
    if not as_unsplit(case):
        return
    want = unsplit_runs[f"{case}/trainer"]["params"]
    for (path, got), w in zip(tree_util.paths(tree["params"]),
                              tree_util.leaves(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def check_restart(results):
    for t in (r["trainer"] for r in results):
        assert t["resumed_steps"] == [3, 4]
        equal_trees(t["resumed"], t["params"])
        equal_trees(t["resumed_opt"], t["opt"])


def check_counts(case, results):
    """``dryrun.layout_collectives`` of the case's cells (the tiny
    config's step on this mesh) names every collective a rank runs, each
    with its operand and group, as often as the rank runs it."""
    cfg, shape = cfg_of(case), mesh_shape(case)
    arch = registry.Arch(cfg)
    assert registry.rules_layout(cfg, table(case), stand_in(shape))
    for got in (r["counts"] for r in results):
        for key, counted in got.items():
            kind, remat = key.split("/")
            where = cell(case, kind)
            batch_axes = dryrun._batch_axes(table(case), stand_in(shape),
                                            where.global_batch)
            want = {}
            for op, operand, group, count in dryrun.layout_collectives(
                    arch, where, table(case), shape, batch_axes, remat):
                want[(op, operand, group)] = \
                    want.get((op, operand, group), 0) + count
            assert counted == want, key
