"""Multi-pod dry-run on the ``meta`` device: run every (architecture x
input-shape x mesh) cell's step on ``meta`` tensors under the op-level
analysis, and record per-device memory and the roofline terms on the
H100 (:data:`repro_torch.core.costmodel.H100_SXM`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  python -m repro_torch.launch.dryrun ... --rules <name>   # rules preset
  python -m repro_torch.launch.dryrun ... --kernels plain  # plain sites
  python -m repro_torch.launch.dryrun ... --remat none     # or dots

Results are cached as JSON under
``results/dryrun_torch/<mesh>/<arch>__<shape>.json`` (one file per cell)
so the sweep is restartable (a non-default ``--rules``, ``--gradsync``,
``--kernels`` or ``--remat`` in a subdirectory, as the reference names
it); ``python -m repro_torch.launch.roofline`` tabulates them.

The port of ``repro.launch.dryrun``, which lowers and compiles each cell
over 512 placeholder host devices.  Three differences:

* **meta, not compiled.** The step (``make_train_step`` then AdamW,
  ``make_serve_step(..., "prefill")`` or ``(..., "decode")`` with
  per-row positions) runs eagerly on ``meta`` tensors: shapes and
  dtypes, nothing computed, nothing allocated, no device touched (CUDA
  is never initialised).  :mod:`repro_torch.launch.opanalysis` counts
  its ops; the kernel sites report their own FLOPs and bytes.  The
  global counts are divided by the mesh's devices for the per-device
  roofline.
* **Collectives are the gradient reduction** (``--gradsync``'s mode
  over the data-parallel axes) and **the MoE's expert-parallel
  all-reduces** over ``"model"`` (:func:`ep_all_reduces`), or where the
  port runs the rules' layout, **the collectives its ranks run**
  (:func:`layout_collectives`: one rank's step on ``meta`` over a
  ledger mesh, every collective counted as it is called: the
  tensor-parallel all-reduces and gathers, the FSDP gathers and
  reduce-scatters, the expert-parallel sums, the gradient reduction
  then left; under ``seq_model`` and ``megatron_seq`` the sequence's
  gathers and reduce-scatters around each mixer, under ``ssm_seq`` the
  Mamba blocks' halo and state gathers, the attention's gathers and
  the whole leaves' gradient all-reduces), each by the ring model.
* **Remat reruns on ``meta``.**  ``--remat none|full|dots`` (default
  ``full``, the reference's) is ``Runtime.remat``: a train cell's
  backward reruns each checkpointed region inside autograd's engine,
  where the analysis sees it, so the rerun's ops count in the FLOPs and
  bytes and its tensors in the live peak.  The rerun stops at a
  region's last saved tensor, as XLA drops the dead recompute, and
  ``dots`` keeps the products' outputs (they are not rerun).
  ``--attn xla|chunked|pallas`` is ``--kernels kernels|plain``
  (``Runtime.kernels``).

Per-device memory: argument bytes (parameters, AdamW state, inputs, and
the cache for decode) and output bytes are exact from the rules'
shardings; ``temp_size_bytes`` is an ESTIMATE, the peak of the live
``meta`` tensors over the step divided by the devices the batch is split
over.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.core import costmodel, ranks
from repro_torch.launch import opanalysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers, registry
from repro_torch.models.config import SHAPES, shape_by_name
from repro_torch.models.runtime import Runtime
from repro_torch.optim import adamw
from repro_torch.train import rules as rules_lib
from repro_torch.train.steps import (BUCKET_BYTES, layout_rank_grads,
                                     make_serve_step, make_train_step)

CHIP = costmodel.H100_SXM
TEMP_ESTIMATE = ("peak of live meta tensors over the step / devices the "
                 "batch is split over")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _batch_bytes(tree, batch_shards: int) -> int:
    """Per-device bytes of batch-major leaves: split over the batch
    shards when the leading dim divides, else replicated (the
    reference's ``_batch_shardings``)."""
    total = 0
    for t in opanalysis.tensor_leaves(tree):
        split = t.dim() and t.shape[0] % batch_shards == 0
        total += _nbytes(t) // batch_shards if split else _nbytes(t)
    return total


def _output_bytes(tree, specs, rules, mesh, batch_shards: int) -> int:
    """Per-device bytes of a step's outputs: a leaf with the shape of a
    spec in ``specs`` (a parameter or a cache leaf) sharded by the
    rules, the rest batch-major."""
    layers.tree_layout(specs, rules, mesh)       # refuses what cannot lie
    by_shape = {s.shape: s for s in layers.spec_leaves(specs)}
    total = 0
    for t in opanalysis.tensor_leaves(tree):
        spec = by_shape.get(tuple(t.shape))
        if spec is not None:
            total += layers.shard_bytes(spec, rules, mesh, t.dtype)
        else:
            total += _batch_bytes(t, batch_shards)
    return total


def _batch_axes(rules: Dict[str, Any], mesh, global_batch: int):
    """The rules' batch axes on ``mesh``, cut to the largest prefix that
    divides the global batch (e.g. full_dp wants 512-way but train_4k
    has batch 256 on the 2-pod mesh -> ('pod', 'data') = 32-way)."""
    target = rules.get("batch", ("pod", "data"))
    axes = target if isinstance(target, tuple) else (target,)
    axes = tuple(a for a in axes if a in mesh.shape)
    while axes and global_batch % math.prod(
            mesh.shape[a] for a in axes) != 0:
        axes = axes[:-1]
    return axes


def cell_layout(arch, shape, multi_pod: bool, rules_name: str):
    """A cell's mesh, its rules (with the batch axes the global batch
    divides), the batch axes and the devices the batch is split over."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_lib.get(rules_name, arch.cfg)
    batch_axes = _batch_axes(rules, mesh, shape.global_batch)
    rules = dict(rules, batch=batch_axes if len(batch_axes) != 1
                 else batch_axes[0])
    return mesh, rules, batch_axes, math.prod(mesh.shape[a]
                                              for a in batch_axes)


def argument_bytes(arch, shape, rules, mesh,
                   batch_shards: int) -> Dict[str, int]:
    """Per-device bytes of a cell's step arguments, by kind: the
    parameters and (train) the AdamW state sharded by ``rules``, the
    inputs split over the batch shards, and (decode) the cache by the
    rules and the per-row positions."""
    specs = arch.param_specs()
    layers.tree_layout(specs, rules, mesh)       # refuses what cannot lie
    if shape.kind == "decode":
        layers.tree_layout(arch.cache_specs(shape), rules, mesh)
    out = {"params": layers.tree_shard_bytes(specs, rules, mesh),
           "inputs": _batch_bytes(arch.input_specs(shape), batch_shards)}
    if shape.kind == "train":
        out["opt_state"] = 4 + 3 * layers.tree_shard_bytes(
            specs, rules, mesh, torch.float32)
    elif shape.kind == "decode":
        out["cache"] = layers.tree_shard_bytes(arch.cache_specs(shape),
                                               rules, mesh)
        out["positions"] = _batch_bytes(
            torch.empty((shape.global_batch,), dtype=torch.int32,
                        device="meta"), batch_shards)
    return out


def ep_all_reduces(cfg, shape, mesh_shape: Dict[str, int], remat: str
                   ) -> list:
    """The MoE's all-reduces over ``"model"`` in one step of a cell
    whose mesh splits the experts there (the reference's
    ``moe_ep_size() > 1``), as the port's expert-parallel layer runs
    them (:mod:`repro_torch.models.moe`), T being the tokens of one data
    shard (the global tokens over the ``("pod", "data")`` axes, the
    reference's ``tok_spec``): ``[(operand bytes, count), ...]``, float32
    each:

    * the forward: (T, d) a MoE layer, the partial outputs' sum;
    * a train cell's backward: (T, d) a layer for the tokens' cotangent
      and (T, K) for the routing weights', and under remat (``full`` or
      ``dots``: the sum is not a product) the forward's (T, d) again in
      each layer's rerun.

    Per device, as the gradient reduction is counted; empty off MoE or
    where ``"model"`` has one device."""
    ep = mesh_shape.get("model", 1)
    if cfg.moe is None or ep <= 1:
        return []
    shards = math.prod(mesh_shape.get(a, 1) for a in ("pod", "data"))
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    t = -(-tokens // shards)
    layer = 4 * t * cfg.d_model
    out = [(layer, cfg.n_layers)]
    if shape.kind == "train":
        out.append((layer, cfg.n_layers * (2 if remat != "none" else 1)))
        out.append((4 * t * cfg.moe.top_k, cfg.n_layers))
    return out


def runs_layout(cfg, rules, mesh, gradsync: str, kind: str):
    """The parameter layout the port runs a cell's step on
    (``registry.rules_layout``, every preset's), or None: a train step
    under a Spindle mode keeps every leaf whole, and what the port
    refuses (a table with some of the mixers' axes on the sequence's
    axis and some whole) is not modelled."""
    if kind == "train" and gradsync != "gspmd":
        return None
    # a leaf the rules cannot lay out raises here; what waits is None
    layers.tree_layout(registry.param_specs(cfg), rules, mesh)
    try:
        return registry.rules_layout(cfg, rules, mesh)
    except ValueError:
        return None


def layout_collectives(arch, shape, rules, mesh_shape: Dict[str, int],
                       batch_axes, remat: str,
                       kernels: str = "kernels") -> list:
    """The collectives one device runs in a step of ``shape``'s cell on
    the rules' layout (:func:`runs_layout`), as the port's ranks run
    them: rank 0's step on ``meta`` tensors over
    ``ranks.RankMesh.ledger(mesh_shape)``, on its blocks of the
    parameters (``layers.shard_params``) and its rows of the global
    batch (the batch over ``batch_axes``), each collective counted by
    ``ranks.ledger``: ``[(kind, operand bytes, group, count), ...]``.  A
    train cell runs the gradient and its reduction
    (``steps.layout_rank_grads``: the tensor-parallel all-reduces, the
    FSDP gathers and reduce-scatters, the MoE's expert-parallel sums,
    the sequence's gathers and reduce-scatters where
    ``layers.seq_axis`` splits it, the gradient's, the loss's and the
    global norm's all-reduces), a
    prefill or decode cell ``make_serve_step`` on the rank's decode
    state (``registry.cache_specs`` at ``registry.tp_ways``)."""
    mesh = ranks.RankMesh.ledger(mesh_shape)
    rt = Runtime(kernels=kernels, remat=remat, mesh=mesh, rules=rules)
    specs = arch.param_specs()
    params = layers.shard_params(layers.abstract_tree(specs), specs, rules,
                                 mesh)
    rows = shape.global_batch // math.prod(mesh_shape.get(a, 1)
                                           for a in batch_axes)
    inputs = arch.input_specs(shape, batch_override=rows)
    with ranks.ledger() as counts:
        if shape.kind == "train":
            layout_rank_grads(arch, rt)(params, inputs)
        elif shape.kind == "prefill":
            with torch.no_grad():
                make_serve_step(arch, rt, "prefill")(params, inputs)
        else:
            cache = layers.abstract_tree(arch.cache_specs(
                shape, batch_override=rows,
                tp=registry.tp_ways(arch.cfg, rt)))
            with torch.no_grad():
                make_serve_step(arch, rt, "decode")(
                    params, cache, inputs,
                    torch.empty((rows,), dtype=torch.int32, device="meta"))
    return [(kind, operand, group, count)
            for (kind, operand, group), count in counts.items()
            if group > 1]


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             rules_name: str = "baseline", gradsync: str = "gspmd",
             kernels: str = "kernels", remat: str = "full"
             ) -> Dict[str, Any]:
    arch = registry.get(arch_name)
    shape = shape_by_name(shape_name)
    record: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "rules": rules_name, "gradsync": gradsync, "kernels": kernels,
        "remat": remat,
    }
    skip = arch.skip_reason(shape)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        return record

    mesh, rules, batch_axes, batch_shards = cell_layout(
        arch, shape, multi_pod, rules_name)
    n_chips = mesh.size
    # one step of the whole global batch; the data-parallel reduction is
    # modelled over the batch axes (opanalysis.gradient_reduction)
    rt = Runtime(kernels=kernels, gradsync=gradsync, remat=remat)
    t0 = time.time()

    specs = arch.param_specs()
    args = argument_bytes(arch, shape, rules, mesh, batch_shards)
    # the step's arguments exist before it runs: only what the step
    # allocates counts toward its temporary memory
    params = layers.abstract_tree(specs)
    inputs = arch.input_specs(shape)
    if shape.kind == "train":
        step = make_train_step(arch, rt, donate=True)
        step_args = (params, adamw.abstract_state(params), inputs)
        grads = [torch.empty(layers.shard_shape(s, rules, mesh),
                             dtype=s.dtype, device="meta")
                 for s in layers.spec_leaves(specs)]
    elif shape.kind == "prefill":
        step = make_serve_step(arch, rt, "prefill")
        step_args = (params, inputs)
    else:  # decode, at per-row positions
        step = make_serve_step(arch, rt, "decode")
        step_args = (params, layers.abstract_tree(arch.cache_specs(shape)),
                     inputs, torch.empty((shape.global_batch,),
                                         dtype=torch.int32, device="meta"))
    layout = runs_layout(arch.cfg, rules, mesh, gradsync, shape.kind)
    collectives = [] if layout is None else layout_collectives(
        arch, shape, rules, mesh.shape, batch_axes, remat, kernels)
    with opanalysis.OpAnalysis() as an:
        out = step(*step_args)
        if shape.kind == "train":
            out_bytes = args["params"] + args["opt_state"] + 4 * len(out[2])
            if layout is None:
                opanalysis.gradient_reduction(an, grads, rt, batch_shards,
                                              n_chips, BUCKET_BYTES)
        else:
            out_bytes = _output_bytes(out, arch.cache_specs(shape), rules,
                                      mesh, batch_shards)
        del out
        if layout is None:
            ep = mesh.shape.get("model", 1)
            for operand, count in ep_all_reduces(arch.cfg, shape,
                                                 mesh.shape, remat):
                an.collective("all-reduce", operand, ep, count)
        for kind, operand, group, count in collectives:
            an.collective(kind, operand, group, count)
    t_trace = time.time() - t0

    met = an.metrics
    per_device = opanalysis.Metrics(dot_flops=met.dot_flops / n_chips,
                                    hbm_bytes=met.hbm_bytes / n_chips,
                                    collectives=met.collectives)
    span = costmodel.axes_span(mesh.shape, batch_axes)
    link_bw = CHIP.collective_bw(span)
    terms = costmodel.roofline_terms(
        met.dot_flops, met.hbm_bytes,
        per_device.collective_wire_bytes * n_chips, n_chips, CHIP, link_bw)
    bound = terms["bound_s"]
    n_tokens = shape.global_batch * (shape.seq_len if not shape.is_decode
                                     else 1)
    model_flops = ((6 if shape.kind == "train" else 2)
                   * arch.cfg.active_param_count() * n_tokens)
    temp = an.peak_bytes // batch_shards
    arg_bytes = sum(args.values())
    top = [{"gbytes": round(b / 1e9, 3), "count": c, "op": op}
           for b, c, op in an.top_hbm_ops(12)]

    record.update({
        "status": "ok",
        "n_chips": n_chips,
        "batch_axes": list(batch_axes),
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_size_bytes": arg_bytes,
            "arguments": args,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": temp,
            "temp_size_is": TEMP_ESTIMATE,
            "peak_bytes": arg_bytes + temp,
            "fits_hbm": arg_bytes + temp <= CHIP.hbm_bytes,
        },
        "ops": {**per_device.to_dict(), "n_ops": an.n_ops,
                "kernels": an.kernels},
        "top_hbm": top,
        "roofline": {
            **terms,
            "chip": CHIP.name,
            "collective_bw": link_bw,
            "model_flops": model_flops,
            "op_flops_global": met.dot_flops,
            "useful_flop_frac": (model_flops / met.dot_flops
                                 if met.dot_flops else None),
            "tokens_per_s_bound": n_tokens / bound if bound > 0 else None,
            "mfu_bound": (model_flops / (bound * n_chips * CHIP.peak_flops)
                          if bound > 0 else None),
        },
    })
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--gradsync", default="gspmd")
    ap.add_argument("--kernels", default="kernels",
                    choices=["kernels", "plain"])
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--variant", default=None,
                    help="subdirectory name for this configuration")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = registry.names() if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        outdir = Path(args.out) / mesh_name
        if args.variant:
            outdir = outdir / args.variant
        elif (args.rules, args.gradsync, args.kernels, args.remat) != \
                ("baseline", "gspmd", "kernels", "full"):
            outdir = outdir / f"{args.rules}__{args.gradsync}__" \
                f"{args.kernels}__{args.remat}"
        outdir.mkdir(parents=True, exist_ok=True)
        for arch in archs:
            for shape in shapes:
                path = outdir / f"{arch}__{shape}.json"
                if path.exists() and not args.force:
                    print(f"[cached] {mesh_name} {arch} {shape}")
                    continue
                print(f"[dryrun] {mesh_name} {arch} {shape} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape, multi, args.rules,
                                   args.gradsync, args.kernels, args.remat)
                except Exception as e:  # record failures — they are bugs
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                path.write_text(json.dumps(rec, indent=2, default=str))
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" bound={r['bound_s']*1e3:.1f}ms"
                             f" trace={rec['trace_s']:.1f}s")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                print(f"[{status}] {mesh_name} {arch} {shape}{extra}",
                      flush=True)


if __name__ == "__main__":
    main()
