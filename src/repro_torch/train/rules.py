"""Sharding-rule presets — the logical->mesh tables the dry-run iterates.

The port of ``repro.train.rules``, preset for preset.  ``get(name,
cfg)`` returns a rules dict for :mod:`repro_torch.models.layers`
(:func:`~repro_torch.models.layers.spec_to_pspec`).  The port executes
on one card, so these tables feed the dry-run's per-device memory and
roofline (:mod:`repro_torch.launch.dryrun`); nothing shards a tensor by
them.  Presets:

  baseline   FSDP over 'data' + tensor parallel over 'model' (MaxText-like)
  megatron   pure TP over 'model', params replicated over 'data' (classic)
  pure_dp    data parallel only — params fully replicated; the explicit
             Spindle gradient-multicast modes run on top of this
  fsdp_only  everything sharded over 'data', no tensor parallelism
  seq_model  sequence dim of activations onto 'model' (sequence-parallel
             lever for long-context shapes)
  megatron_seq  megatron + the sequence on 'model' between the mixers
  ssm_seq    the sequence on 'model' with every mixer whole: the Mamba
             state handed from rank to rank
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DEFAULT_RULES


def _base() -> Dict[str, Any]:
    return dict(DEFAULT_RULES)


def get(name: str, cfg: ModelConfig) -> Dict[str, Any]:
    if name == "baseline":
        rules = _base()
    elif name == "megatron":
        rules = _base()
        rules["fsdp_embed"] = None
    elif name == "full_dp":
        # every mesh axis is data parallel: params replicated, batch
        # sharded 256-way.  The right regime for small models at train_4k
        # — zero forward collectives; the gradient multicast (one fused
        # all-reduce) is the only coordination, exactly the paper's
        # small-message world
        rules = _base()
        rules.update({"batch": ("pod", "data", "model"),
                      "fsdp_embed": None, "heads": None, "kv_heads": None,
                      "mlp": None, "vocab": None, "ssm_inner": None,
                      "ssm_heads": None, "experts": None})
    elif name == "pure_dp":
        rules = _base()
        rules.update({"fsdp_embed": None, "heads": None, "kv_heads": None,
                      "mlp": None, "vocab": None, "ssm_inner": None,
                      "ssm_heads": None})
        # experts stay on 'model' (EP) — replicating 60 experts per device
        # would not fit
    elif name == "fsdp_only":
        rules = _base()
        rules.update({"heads": None, "kv_heads": None, "mlp": "data",
                      "vocab": "data", "ssm_inner": "data",
                      "ssm_heads": None, "experts": "model"})
    elif name == "seq_model":
        rules = _base()
        rules["seq"] = "model"
    elif name == "megatron_seq":
        # classic TP + sequence-parallel residual stream: the (B,S,d)
        # activations (and their f32 backward cotangents) shard S over
        # 'model' between attention/MLP blocks
        rules = _base()
        rules["fsdp_embed"] = None
        rules["seq"] = "model"
    elif name == "ssm_seq":
        # sequence parallelism for recurrent stacks: activations shard the
        # SEQUENCE over 'model', ssm weights replicate across it — the
        # per-layer TP all-reduce of (B,S,d) disappears entirely; the
        # cross-shard state handoff is tiny (B,H,P,N)
        rules = _base()
        rules.update({"seq": "model", "ssm_inner": None, "ssm_heads": None,
                      "heads": None, "kv_heads": None, "mlp": None})
    else:
        raise KeyError(f"unknown rules preset {name!r}")
    return rules


PRESETS = ("baseline", "megatron", "pure_dp", "fsdp_only", "seq_model",
           "megatron_seq", "ssm_seq")
