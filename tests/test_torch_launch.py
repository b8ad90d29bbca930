"""The port's launch plane (``repro_torch.launch``), the sharding rules
(``models.layers`` rules, ``train/rules.py``) and the meta branch of the
kernel sites, against the reference on the CPU.

* rules: every preset (and ``full_dp``), every registered arch at full
  size, both production meshes — each parameter's partition equals the
  reference's ``spec_to_pspec`` as tuples (the reference reads only
  ``mesh.shape``, so a stand-in with ``.shape`` serves);
* ``adamw.abstract_state``: shapes and dtypes equal the reference's;
* ``opanalysis``: dot FLOPs of a 2-layer, width-64 dense prefill and
  train step with plain kernel sites within 2% of the reference's
  ``hloanalysis.analyze_text`` of the same step compiled on the CPU
  (``attn_impl="xla"``), under each ``remat`` policy on both sides;
* the dry-run: every full-size cell on the single-pod mesh runs on
  ``meta`` and is ``skipped`` exactly where the reference's
  ``skip_reason`` says so; per-device argument bytes of the parameters
  and the AdamW state equal the shard bytes of the reference's
  partitions; CUDA is never initialised;
* ``roofline.row`` equals the reference's on every column but ``note``;
* the serve launcher's token streams equal the reference
  ``ServeEngine``'s in float32 on the reduced config; the train
  launcher builds the reference's ``TrainConfig`` from the same argv and
  trains two steps.

``repro.launch.dryrun`` is never imported: its first lines set
``XLA_FLAGS`` for 512 host devices.
"""

import json
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hloanalysis
from repro.launch import mesh as ref_mesh
from repro.launch import roofline as ref_roofline
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.runtime import Runtime as RefRuntime
from repro.optim import adamw as ref_adamw
from repro.serve import engine as ref_engine
from repro.train import rules as ref_rules
from repro.train import steps as ref_steps
from repro_torch.core import costmodel
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh, opanalysis, roofline, serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import convert, layers, registry
from repro_torch.models.config import SHAPES, ModelConfig, shape_by_name
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import rules, steps

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
PRESETS = ref_rules.PRESETS + ("full_dp",)


def _model_archs(reg, package):
    """The archs a configs package registers (other test files register
    tiny test archs in the same process)."""
    reg.names()                         # registers the configs
    return tuple(sorted(name for name, build in reg._REGISTRY.items()
                        if build.__module__.startswith(package)))


ARCHS = _model_archs(registry, "repro_torch.configs.")


def _flat(tree, leaf_type, prefix=""):
    if isinstance(tree, leaf_type):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], leaf_type, f"{prefix}/{k}"))
    return out


def _stand_in(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def test_port_lists_the_reference_archs_and_presets():
    assert len(ARCHS) == 10
    assert ARCHS == _model_archs(ref_registry, "repro.configs.")
    assert rules.PRESETS == ref_rules.PRESETS
    assert layers.DEFAULT_RULES == ref_layers.DEFAULT_RULES


@pytest.mark.parametrize("preset", PRESETS)
def test_rules_partitions_equal_the_reference(preset):
    for name in ARCHS:
        port_specs = _flat(registry.get(name).param_specs(),
                           layers.ParamSpec)
        ref_specs = _flat(ref_registry.get(name).param_specs(),
                          ref_layers.ParamSpec)
        assert port_specs.keys() == ref_specs.keys(), name
        port_rules = rules.get(preset, registry.get(name).cfg)
        ref_rules_ = ref_rules.get(preset, ref_registry.get(name).cfg)
        assert port_rules == ref_rules_, (preset, name)
        for m in MESHES:
            stand_in = _stand_in(m)
            got = _flat(layers.tree_pspecs(registry.get(name).param_specs(),
                                           port_rules, stand_in), tuple)
            assert got.keys() == ref_specs.keys()
            for path, spec in port_specs.items():
                want = tuple(ref_layers.spec_to_pspec(ref_specs[path],
                                                      ref_rules_, stand_in))
                assert got[path] == want == layers.spec_to_pspec(
                    spec, port_rules, stand_in), (preset, name, m, path)


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        rules.get("nope", registry.get("qwen3-1.7b").cfg)


def test_shard_shape_divides_the_partitioned_dims():
    spec = layers.ParamSpec((151936, 2048), ("vocab", "fsdp_embed"))
    m = mesh.make_production_mesh()
    assert layers.spec_to_pspec(spec, layers.DEFAULT_RULES, m) == \
        ("model", "data")
    assert layers.shard_shape(spec, layers.DEFAULT_RULES, m) == (9496, 128)
    assert layers.shard_bytes(spec, layers.DEFAULT_RULES, m) == \
        9496 * 128 * 2
    # a dim that does not divide its mesh axes stays whole
    odd = layers.ParamSpec((8, 30), ("kv_heads", "fsdp_embed"))
    assert layers.shard_shape(odd, layers.DEFAULT_RULES, m) == (8, 30)


def test_meshes_keep_the_reference_layouts():
    single, multi = mesh.make_production_mesh(), \
        mesh.make_production_mesh(multi_pod=True)
    assert single.shape == MESHES["single"] and single.size == 256
    assert multi.shape == MESHES["multi"] and multi.size == 512
    assert single.devices is None and multi.devices is None
    for m in MESHES:
        assert mesh.dp_axes(mesh.make_production_mesh(
            multi_pod=m == "multi")) == ref_mesh.dp_axes(_stand_in(m))
    smoke = mesh.make_smoke_mesh(device="cpu")
    assert smoke.shape == {"data": 1}
    assert smoke.devices == (torch.device("cpu"),)


def test_abstract_state_matches_the_reference():
    name = "qwen2-moe-a2.7b"        # bf16 leaves and a float32 router
    got = adamw.abstract_state(layers.abstract_tree(
        registry.get(name).param_specs()))
    want = ref_adamw.abstract_state(ref_layers.abstract_tree(
        ref_registry.get(name).param_specs()))
    assert got["step"].shape == want["step"].shape == ()
    assert got["step"].dtype == torch.int32 and got["step"].is_meta
    for key in ("master", "m", "v"):
        g = _flat(got[key], torch.Tensor)
        w = _flat(want[key], jax.ShapeDtypeStruct)
        assert g.keys() == w.keys()
        for path in g:
            assert tuple(g[path].shape) == tuple(w[path].shape), path
            assert str(w[path].dtype) == "float32", path
            assert g[path].dtype == torch.float32 and g[path].is_meta


TINY = dict(name="launch-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
FLOPS_RTOL = 0.02


# (kind, remat); the remat-free cases keep their kind alone as their id
FLOPS_CASES = [pytest.param(kind, remat, id=kind if remat == "none"
                            else f"{kind}-{remat}")
               for remat in ("none", "full", "dots")
               for kind in ("prefill", "train")]


@pytest.mark.parametrize("kind,remat", FLOPS_CASES)
def test_opanalysis_dot_flops_match_the_reference_hlo(kind, remat):
    """The reference's XLA drops the rerun's dead products as torch's
    rerun stops at a region's last saved tensor, and ``dots`` keeps the
    products on both sides: the counts agree under each policy."""
    b, s = 2, 32
    ref_arch = ref_registry.Arch(cfg=RefModelConfig(**TINY))
    ref_rt = RefRuntime(attn_impl="xla", remat=remat)
    abstract = ref_layers.abstract_tree(ref_arch.param_specs())
    tokens = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if kind == "train":
        lowered = jax.jit(ref_steps.make_train_step(ref_arch, ref_rt)).lower(
            abstract, ref_adamw.abstract_state(abstract), tokens)
    else:
        lowered = jax.jit(ref_steps.make_serve_step(
            ref_arch, ref_rt, kind="prefill")).lower(abstract, tokens)
    want = hloanalysis.analyze_text(lowered.compile().as_text(), 1)

    arch = registry.Arch(ModelConfig(**TINY))
    params = layers.abstract_tree(arch.param_specs())
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    rt = Runtime(kernels="plain", remat=remat)
    with opanalysis.OpAnalysis() as an:
        if kind == "train":
            steps.make_train_step(arch, rt, donate=True)(
                params, adamw.abstract_state(params), batch)
        else:
            steps.make_serve_step(arch, rt, "prefill")(params, batch)
    got = an.metrics.dot_flops
    dots = {op: n for op, (_, n) in an.by_op.items() if "mm" in op}
    assert abs(got / want.dot_flops - 1) <= FLOPS_RTOL, \
        (kind, got, want.dot_flops, dots)
    assert an.metrics.hbm_bytes > 0 and an.kernels == {}


def _site_inputs():
    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {
        "flash_attention": ((m(2, 64, 4, 32), m(2, 64, 2, 32),
                             m(2, 64, 2, 32)), {},
                            4 * 2 * 4 * 32 * (64 * 65 // 2)),
        "flash_decode": ((m(2, 4, 32), m(2, 48, 2, 32), m(2, 48, 2, 32),
                          m(2, dtype=torch.int32)), {}, 4 * 2 * 4 * 32 * 48),
        "rms_norm": ((m(6, 64), m(64)), {}, 0),
        "rms_norm_residual": ((m(6, 64), m(6, 64), m(64)), {}, 0),
        "ssd_scan": ((m(1, 64, 4, 16), m(1, 64, 4, dtype=torch.float32),
                      m(4, dtype=torch.float32), m(1, 64, 1, 16),
                      m(1, 64, 1, 16), m(4, dtype=torch.float32),
                      m(4, dtype=torch.float32), 32), {},
                     1 * 2 * (1 * 2 * 16 * 528
                              + 4 * (2 * 16 * 528 + 4 * 32 * 16 * 16))),
        "quantize": ((m(64, dtype=torch.float32), 16), {}, 0),
        "dequantize": ((m(64, dtype=torch.int8),
                        m(4, dtype=torch.float32), 16), {}, 0),
    }


@pytest.mark.parametrize("site", sorted(_site_inputs()))
def test_kernel_sites_report_one_op_on_meta(site):
    args, kwargs, flops = _site_inputs()[site]
    fn = getattr(ops, site)
    before = ops.launch_counts()
    with opanalysis.OpAnalysis() as an:
        out = fn(*args, **kwargs)
    assert ops.launch_counts() == before
    outs = out if isinstance(out, tuple) else (out,)
    cpu_args = [torch.zeros(a.shape, dtype=a.dtype)
                if isinstance(a, torch.Tensor) else a for a in args]
    if site == "flash_decode":
        cpu_args[3] = torch.full((2,), 48, dtype=torch.int32)
    want = fn(*cpu_args)            # the CPU branch: the plain version
    wants = want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype) for o in outs] == \
        [(w.shape, w.dtype) for w in wants]
    assert all(o.is_meta for o in outs)
    nbytes = sum(t.numel() * t.element_size() for t in
                 [a for a in args if isinstance(a, torch.Tensor)]
                 + list(outs))
    assert an.kernels == {site: {"launches": 1, "dot_flops": flops,
                                 "bytes": nbytes}}
    assert an.metrics.dot_flops == flops
    assert an.metrics.hbm_bytes == nbytes


def test_meta_sites_take_the_plain_backward():
    q = torch.empty((1, 32, 4, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 32, 2, 16), device="meta", requires_grad=True)
    v = torch.empty((1, 32, 2, 16), device="meta", requires_grad=True)
    x = torch.empty((3, 16), device="meta", requires_grad=True)
    w = torch.empty((16,), device="meta", requires_grad=True)
    with opanalysis.OpAnalysis() as an:
        out = ops.flash_attention(q, k, v, True)
        y = ops.rms_norm(x, w)
        grads = torch.autograd.grad(out.sum() + y.sum(), [q, k, v, x, w])
    assert [g.shape for g in grads] == [t.shape for t in (q, k, v, x, w)]
    assert an.kernels["flash_attention"]["launches"] == 1
    assert an.kernels["rms_norm"]["launches"] == 1
    # the backward recomputes the plain attention: its products show
    assert an.by_op["aten::bmm"][1] >= 4


def test_roofline_rows_match_the_reference():
    ok = {"arch": "qwen3-1.7b", "shape": "train_4k", "status": "ok",
          "roofline": {"compute_s": 0.0563, "memory_s": 0.3125,
                       "collective_s": 0.001, "dominant": "memory",
                       "useful_flop_frac": 0.76, "mfu_bound": 0.137}}
    compute = {"arch": "a", "shape": "prefill_32k", "status": "ok",
               "roofline": {"compute_s": 1.5, "memory_s": 0.2,
                            "collective_s": 0.0, "dominant": "compute",
                            "useful_flop_frac": 0.3, "mfu_bound": 0.6}}
    nofrac = {"arch": "a", "shape": "decode_32k", "status": "ok",
              "roofline": {"compute_s": 0.0, "memory_s": 0.002,
                           "collective_s": 0.5, "dominant": "collective",
                           "useful_flop_frac": None, "mfu_bound": None}}
    skipped = {"arch": "qwen3-1.7b", "shape": "long_500k",
               "status": "skipped", "reason": "full attention " * 10}
    error = {"arch": "x", "shape": "y", "status": "error",
             "error": "RuntimeError: " + "z" * 100}
    cells = [ok, compute, nofrac, skipped, error]
    for cell in cells:
        got, want = roofline.row(cell), ref_roofline.row(cell)
        assert got.keys() == want.keys()
        for key in want:
            if key != "note":
                assert got[key] == want[key], (cell["shape"], key)
    assert roofline.row(skipped)["note"] == ref_roofline.row(skipped)["note"]
    assert roofline.render_md(cells).splitlines()[0] == \
        ref_roofline.render_md(cells).splitlines()[0]
    assert len(roofline.render_csv(cells).splitlines()) == 6


def test_roofline_terms_match_the_reference_formula():
    chip = costmodel.H100_SXM
    from repro.core import costmodel as ref_costmodel
    ref_chip = ref_costmodel.ChipModel(
        name=chip.name, peak_flops=chip.peak_flops, hbm_bw=chip.hbm_bw,
        ici_bw=chip.link_bw, hbm_bytes=chip.hbm_bytes, vmem_bytes=0)
    for args in ((3e15, 2e12, 1e9, 256), (1e12, 5e13, 0.0, 512)):
        assert costmodel.roofline_terms(*args, chip) == \
            ref_costmodel.roofline_terms(*args, ref_chip)
    assert (chip.peak_flops, chip.hbm_bw, chip.hbm_bytes) == \
        (989.4e12, 3.35e12, 80e9)
    # both axes of both production meshes span more than one 8-GPU node
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        for axes in [(a,) for a in m.shape] + [mesh.dp_axes(m)]:
            span = costmodel.axes_span(m.shape, axes)
            assert span > chip.node_size
            assert chip.collective_bw(span) == chip.inter_node_bw == 50e9
    assert costmodel.axes_span({"data": 2, "model": 4}, ("model",)) == 4
    assert chip.collective_bw(4) == chip.link_bw == 450e9


@pytest.fixture(scope="module")
def single_cells():
    """Every arch x shape on the single-pod mesh, run on meta."""
    assert not torch.cuda.is_initialized()
    cells = {(a, s.name): dryrun.run_cell(a, s.name, False)
             for a in ARCHS for s in SHAPES}
    assert not torch.cuda.is_initialized()
    return cells


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_skips_exactly_where_the_reference_says(arch, single_cells):
    ref = ref_registry.get(arch)
    for shape in SHAPES:
        rec = single_cells[(arch, shape.name)]
        reason = ref.skip_reason(shape)
        if reason:
            assert rec["status"] == "skipped" and rec["reason"] == reason
        else:
            assert rec["status"] == "ok", (shape.name, rec.get("error"))
            assert rec["n_chips"] == 256 and rec["trace_s"] >= 0
            r = rec["roofline"]
            assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                                       r["collective_s"]) > 0
            # the reference's 6 N T model FLOPs: above the step's products
            # for the encdec, whose encoder and decoder each see half
            assert r["mfu_bound"] > 0
            assert rec["ops"]["collectives_modelled"] == \
                "gradient reduction"


def _ref_shard_bytes(ref_specs, ref_rules_, stand_in, dtype=None):
    total = 0
    for spec in _flat(ref_specs, ref_layers.ParamSpec).values():
        pspec = tuple(ref_layers.spec_to_pspec(spec, ref_rules_, stand_in))
        n = 1
        for dim, entry in zip(spec.shape, pspec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(stand_in.shape[a] for a in axes)
        total += n * np.dtype(dtype or spec.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_dryrun_argument_bytes_equal_the_reference_shards(mesh_name,
                                                          single_cells):
    shape = shape_by_name("train_4k")
    stand_in = _stand_in(mesh_name)
    for name in ARCHS:
        arch = registry.get(name)
        m, port_rules, _, shards = dryrun.cell_layout(
            arch, shape, mesh_name == "multi", "baseline")
        ref_specs = ref_registry.get(name).param_specs()
        ref_rules_ = dict(ref_rules.get("baseline",
                                        ref_registry.get(name).cfg),
                          batch=port_rules["batch"])
        args = dryrun.argument_bytes(arch, shape, port_rules, m, shards)
        want_params = _ref_shard_bytes(ref_specs, ref_rules_, stand_in)
        want_opt = 4 + 3 * _ref_shard_bytes(ref_specs, ref_rules_,
                                            stand_in, np.float32)
        assert (args["params"], args["opt_state"]) == \
            (want_params, want_opt), (name, mesh_name)
        assert args["inputs"] == sum(
            math.prod(t.shape) * t.element_size()
            for t in arch.input_specs(shape).values()) // shards
        if mesh_name == "single":
            rec = single_cells[(name, "train_4k")]
            assert rec["memory"]["arguments"] == args
            assert rec["memory"]["argument_size_bytes"] == \
                sum(args.values())


def test_dryrun_counts_the_moe_expert_parallel_all_reduces(monkeypatch):
    """qwen2-moe-a2.7b on one pod under ``pure_dp`` (every other leaf
    whole, the experts split over ``"model"``, 16 devices): a float32
    (T, d) all-reduce a MoE layer in the forward, T the tokens of one of
    the 16 data shards; a train cell adds the tokens' cotangent (T, d),
    the routing weights' (T, K) and, under the default remat, the
    forward's again in the rerun.  Ring wire bytes: 2 (g - 1) / g of the
    operand.  Under ``baseline`` the rules lay the MoE out and its
    collectives are its ranks' (``layout_collectives``, held to the
    ranks in ``tests/test_torch_family_layouts.py``)."""
    name, d, k, n_layers = "qwen2-moe-a2.7b", 2048, 4, 24
    ring = 2 * 15 / 16
    cells = {s: dryrun.run_cell(name, s, False, "pure_dp")
             for s in ("prefill_32k", "decode_32k", "train_4k")}
    for shape_name in ("prefill_32k", "decode_32k"):
        shape = shape_by_name(shape_name)
        t = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
        operand = n_layers * 4 * (t // 16) * d
        assert cells[shape_name]["ops"]["collectives"] == {
            "all-reduce": {"count": n_layers, "operand_bytes": operand,
                           "wire_bytes": operand * ring}}, shape_name
    with_ep = cells["train_4k"]["ops"]["collectives"]["all-reduce"]
    monkeypatch.setattr(dryrun, "ep_all_reduces", lambda *a: [])
    without = dryrun.run_cell(name, "train_4k", False, "pure_dp")["ops"][
        "collectives"]["all-reduce"]
    t = 256 * 4096 // 16
    operand = n_layers * (3 * 4 * t * d + 4 * t * k)
    assert with_ep["count"] - without["count"] == 4 * n_layers
    assert with_ep["operand_bytes"] - without["operand_bytes"] == operand
    assert with_ep["wire_bytes"] - without["wire_bytes"] == \
        pytest.approx(operand * ring, rel=1e-12)


def test_dryrun_counts_the_dense_layout_collectives(single_cells):
    """qwen3-1.7b under ``baseline`` on one pod (16 x 16): 16 heads, the
    MLP and the vocabulary split over ``"model"`` (its 8 kv heads stay
    whole), every ``fsdp_embed`` dim over ``"data"``.  A prefill of 32 x
    32768 (T = 2 x 32768 tokens a data shard): the lookup's bfloat16
    all-reduce (T, d), each layer's float32 sums of the attention and
    the MLP (T, d), the last position's logits gathered (2, V / 16); the
    FSDP gathers of each layer's 7 blocks and of the tied embedding
    twice.  A decode of 128 rows: the same at T = 8, no cache collective.
    """
    d, heads, kv, hd, ff, vocab, n_layers = 2048, 16, 8, 128, 6144, \
        151936, 28
    blocks = [d // 16 * heads // 16 * hd, d // 16 * kv * hd,
              d // 16 * kv * hd, heads // 16 * hd * d // 16,
              d // 16 * ff // 16, d // 16 * ff // 16, ff // 16 * d // 16]
    embed = vocab // 16 * d // 16
    ring, gather = 2 * 15 / 16, 15
    for shape_name, rows, seq in (("prefill_32k", 2, 32768),
                                  ("decode_32k", 8, 1)):
        t = rows * seq
        reduce_ops = [(2 * t * d, 1), (4 * t * d, 2 * n_layers)]
        gather_ops = [(2 * rows * vocab // 16, 1), (2 * embed, 2)] + \
            [(2 * b, n_layers) for b in blocks]
        got = single_cells[("qwen3-1.7b", shape_name)]["ops"]["collectives"]
        assert set(got) == {"all-reduce", "all-gather"}, shape_name
        for kind, ops_, factor in (("all-reduce", reduce_ops, ring),
                                   ("all-gather", gather_ops, gather)):
            operand = sum(b * c for b, c in ops_)
            assert got[kind]["count"] == sum(c for _, c in ops_), kind
            assert got[kind]["operand_bytes"] == operand, kind
            assert got[kind]["wire_bytes"] == pytest.approx(
                operand * factor, rel=1e-12), kind


def test_dryrun_train_layout_replaces_the_per_leaf_all_reduce(single_cells):
    """A baseline train cell reduces no FSDP leaf by the per-leaf
    all-reduce over ``"data"`` (its gradient is reduce-scattered there),
    and a Spindle mode, whose leaves stay whole, keeps that reduction
    and adds no layout collective."""
    got = single_cells[("qwen3-1.7b", "train_4k")]["ops"]["collectives"]
    assert set(got) == {"all-reduce", "all-gather", "reduce-scatter"}
    spindle = dryrun.run_cell("qwen3-1.7b", "train_4k", False,
                              gradsync="spindle_per_tensor")
    assert set(spindle["ops"]["collectives"]) == {"all-reduce"}
    assert spindle["ops"]["collectives"]["all-reduce"]["count"] == len(
        list(layers.spec_leaves(registry.get("qwen3-1.7b").param_specs())))


def _abstract_mesh(name):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(MESHES[name].values()), tuple(MESHES[name]))


def _reference_refuses(spec, rules_, mesh_) -> bool:
    """Whether the reference's ``NamedSharding`` refuses ``spec``'s
    partition (what ``layers.tree_shardings`` builds), compiling
    nothing."""
    from jax.sharding import NamedSharding
    try:
        NamedSharding(mesh_, ref_layers.spec_to_pspec(spec, rules_, mesh_))
    except Exception as e:  # noqa: BLE001 - the class is jax-internal
        assert type(e).__name__ == "DuplicateSpecError", e
        return True
    return False


def _port_refuses(path, spec, rules_, stand_in) -> bool:
    try:
        layers.check_partition(path, layers.spec_to_pspec(spec, rules_,
                                                          stand_in))
    except ValueError as e:
        assert path in str(e)
        return True
    return False


def _refusals(arch_name, ref_arch, preset, mesh_name):
    """Per leaf of the parameters and of each decode cell's cache, the
    port's refusal and the reference's, under the cell's rules."""
    arch = registry.get(arch_name)
    stand_in, abstract = _stand_in(mesh_name), _abstract_mesh(mesh_name)
    out = []
    for shape in SHAPES:
        _, rules_, _, _ = dryrun.cell_layout(arch, shape,
                                             mesh_name == "multi", preset)
        trees = [(arch.param_specs(), ref_arch.param_specs())]
        if shape.kind == "decode":
            trees.append((arch.cache_specs(shape),
                          ref_arch.cache_specs(shape)))
        for port_tree, ref_tree in trees:
            port_leaves = _flat(port_tree, layers.ParamSpec)
            for path, spec in _flat(ref_tree, ref_layers.ParamSpec).items():
                out.append(((shape.name, path), _port_refuses(
                    path, port_leaves[path], rules_, stand_in),
                    _reference_refuses(spec, rules_, abstract)))
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_layout_refusals_fall_leaf_for_leaf_where_the_reference_raises(
        preset):
    """Every arch and the tiny config, both production meshes: the port
    refuses a leaf's layout exactly where the reference's
    ``NamedSharding`` raises: ``fsdp_only`` puts ``"data"`` twice in the
    leaves whose ``mlp`` or ``vocab`` dim shares it with ``fsdp_embed``;
    the sequence-parallel presets put ``"model"`` twice in a cache whose
    kv heads divide it; the others never refuse."""
    if "launch-tiny" not in registry.names():
        registry.register("launch-tiny", lambda: ModelConfig(**TINY))
    archs = [(name, ref_registry.get(name)) for name in ARCHS] + \
        [("launch-tiny", ref_registry.Arch(cfg=RefModelConfig(**TINY)))]
    refused = 0
    for name, ref_arch in archs:
        for mesh_name in MESHES:
            for where, port, ref in _refusals(name, ref_arch, preset,
                                              mesh_name):
                assert port == ref, (name, mesh_name, where)
                refused += ref
    if preset == "fsdp_only":
        assert refused > 0
    elif preset in ("baseline", "megatron", "pure_dp", "full_dp"):
        assert refused == 0


@pytest.mark.parametrize("preset", PRESETS)
def test_dryrun_records_error_exactly_where_the_reference_would(preset,
                                                                tmp_path):
    """The dry-run over the tiny config, every shape, both meshes: a cell
    records ``error`` where the reference's ``run_cell`` cannot build
    its parameters' (or a decode cell's cache's) shardings, ``ok``
    elsewhere."""
    if "launch-tiny" not in registry.names():
        registry.register("launch-tiny", lambda: ModelConfig(**TINY))
    ref_arch = ref_registry.Arch(cfg=RefModelConfig(**TINY))
    dryrun.main(["--arch", "launch-tiny", "--shape", "all", "--mesh", "both",
                 "--rules", preset, "--out", str(tmp_path)])
    for mesh_name, mesh_dir in (("single", "pod16x16"),
                                ("multi", "pod2x16x16")):
        refuses = {}
        for (shape_name, _), _, ref in _refusals("launch-tiny", ref_arch,
                                                 preset, mesh_name):
            refuses[shape_name] = refuses.get(shape_name, False) or ref
        for shape in SHAPES:
            [path] = (tmp_path / mesh_dir).rglob(
                f"launch-tiny__{shape.name}.json")
            rec = json.loads(path.read_text())
            want = "error" if refuses[shape.name] else "ok"
            assert rec["status"] == want, (mesh_name, shape.name,
                                           rec.get("error"))
            if want == "error":
                assert "mesh axis 'data'" in rec["error"]


def test_dryrun_never_initialises_cuda(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise AssertionError("the dry-run initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    before = dict(os.environ)
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--gradsync", "spindle",
                 "--kernels", "plain"])
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                 "--out", str(tmp_path), "--gradsync",
                 "spindle_compressed"])
    assert dict(os.environ) == before
    assert not torch.cuda.is_initialized()
    plain = json.loads((tmp_path / "pod16x16" /
                        "baseline__spindle__plain__full" /
                        "mamba2-2.7b__decode_32k.json").read_text())
    assert plain["status"] == "ok" and plain["ops"]["kernels"] == {}
    comp = json.loads((tmp_path / "pod16x16" /
                       "baseline__spindle_compressed__kernels__full" /
                       "qwen3-1.7b__train_4k.json").read_text())
    coll = comp["ops"]["collectives"]
    assert set(coll) == {"reduce-scatter", "all-gather"}
    assert coll["reduce-scatter"]["count"] == coll["all-gather"]["count"]
    # the compressed leg's quantize pair runs on every device
    assert comp["ops"]["kernels"]["quantize"]["launches"] == \
        256 * coll["all-gather"]["count"]
    cells = roofline.load_cells(tmp_path, "pod16x16",
                                "baseline__spindle_compressed__kernels__full")
    assert roofline.row(cells[0])["status"] == "ok"


def test_dryrun_remat_moves_the_train_cells_temp_memory(single_cells):
    """qwen3-1.7b ``train_4k`` on one pod: the live-meta peak of the
    default ``full`` cell is below ``none``'s (every layer's activations
    kept) and ``dots``' (the products' outputs kept) lies between them;
    the rerun adds products under ``full`` only."""
    full = single_cells[("qwen3-1.7b", "train_4k")]
    none, dots = (dryrun.run_cell("qwen3-1.7b", "train_4k", False,
                                  remat=r) for r in ("none", "dots"))
    assert [c["remat"] for c in (none, full, dots)] == \
        ["none", "full", "dots"]
    temp = [c["memory"]["temp_size_bytes"] for c in (full, dots, none)]
    assert temp[0] < temp[1] < temp[2], temp
    flops = [c["roofline"]["op_flops_global"] for c in (none, dots, full)]
    assert flops[0] < flops[2] and flops[1] < flops[2], flops
    # the kernel sites rerun under both policies
    assert dots["ops"]["kernels"] == full["ops"]["kernels"]
    assert full["ops"]["kernels"]["flash_attention"]["launches"] == \
        2 * none["ops"]["kernels"]["flash_attention"]["launches"]


def test_dryrun_records_the_remat_and_names_its_directory(tmp_path):
    """The reference's layout: the default (``full``) cells straight
    under the mesh, any non-default flag in
    ``<rules>__<gradsync>__<kernels>__<remat>``."""
    argv = ["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--out",
            str(tmp_path)]
    dryrun.main(argv)
    dryrun.main(argv + ["--remat", "dots"])
    base = tmp_path / "pod16x16"
    default = json.loads((base / "qwen3-1.7b__decode_32k.json").read_text())
    dots = json.loads((base / "baseline__gspmd__kernels__dots" /
                       "qwen3-1.7b__decode_32k.json").read_text())
    assert (default["remat"], dots["remat"]) == ("full", "dots")
    assert default["status"] == dots["status"] == "ok"
    with pytest.raises(SystemExit):
        dryrun.main(argv + ["--remat", "selective"])


def _serve_args(seed=3):
    return serve.parse_args(["--arch", "qwen3-1.7b", "--requests", "5",
                             "--prompt-len", "6", "--max-new", "5",
                             "--max-batch", "2", "--seed", str(seed)])


def test_serve_launcher_tokens_equal_the_reference(monkeypatch, capsys):
    args = _serve_args()
    ref_cfg = ref_registry.get(args.arch).cfg.reduced()
    tree = ref_layers.init_tree(ref_registry.param_specs(ref_cfg),
                                jax.random.key(args.seed))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    monkeypatch.setattr(ref_layers, "DEFAULT_DTYPE", jnp.float32)
    eng = ref_engine.ServeEngine(
        args.arch, jax.tree.map(jnp.asarray, tree), ref_cfg,
        ref_engine.EngineConfig(max_batch=args.max_batch,
                                max_len=serve.MAX_LEN), RefRuntime())
    eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(ref_engine.Request(
            rid=i, prompt=rng.integers(0, ref_cfg.vocab_size,
                                       size=args.prompt_len, dtype=np.int32),
            max_new_tokens=args.max_new))
    want = {r.rid: list(r.tokens_out) for r in eng.run_until_drained()}

    cfg = registry.get(args.arch).cfg.reduced()
    params = convert.params_from_numpy(tree, cfg, "cpu", torch.float32)
    done = serve.serve(args, params=params, device="cpu")
    got = {r.rid: list(r.tokens_out) for r in done}
    assert got == want
    assert all(len(t) == args.max_new for t in got.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"served {args.requests} requests, "
                               f"{args.requests * args.max_new} tokens in")
    assert lines[1].startswith("latency mean ")


def test_launchers_want_a_gpu_by_default():
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--arch", "qwen3-1.7b", "--reduced",
                             "--steps", "1"])


def test_train_launcher_builds_the_reference_config(monkeypatch):
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "2",
            "--seq-len", "32", "--global-batch", "2", "--log-every", "1",
            "--checkpoint-every", "7", "--seed", "5"]
    import repro.launch.train as ref_train
    seen = {}

    class Recorder:
        def __init__(self, name, cfg, tcfg, rt):
            seen.update(name=name, cfg=cfg, tcfg=tcfg)

        def run(self):
            seen["ran"] = True

    monkeypatch.setattr(ref_train, "Trainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train.main()
    assert seen["ran"]

    tr = train_launcher.train(train_launcher.parse_args(argv),
                              device="cpu")
    fields = ("steps", "seq_len", "global_batch", "checkpoint_every",
              "checkpoint_dir", "keep_checkpoints", "log_every", "seed",
              "data_patterns")
    assert {f: getattr(tr.tcfg, f) for f in fields} == \
        {f: getattr(seen["tcfg"], f) for f in fields}
    assert tr.cfg.n_layers == seen["cfg"].n_layers == 2
    assert (tr.cfg.d_model, tr.cfg.vocab_size) == \
        (seen["cfg"].d_model, seen["cfg"].vocab_size)
    assert [h["step"] for h in tr.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert abs(tr.history[0]["loss"] - math.log(tr.cfg.vocab_size)) < 1.0
