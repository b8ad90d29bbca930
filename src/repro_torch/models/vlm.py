"""InternVL2-style VLM: a stubbed vision frontend and an InternLM2
decoder backbone.

The port of ``repro.models.vlm``.  The modality frontend is a stub, as
in the reference: :func:`repro_torch.models.registry.input_specs`
provides precomputed InternViT patch embeddings (B, n_patches,
vision_dim), cast here to the weights' dtype.  They pass through the
2-layer MLP projector (an ``rms_norm`` site at width ``vision_dim``, a
tanh-approximate GELU in float32, as ``jax.nn.gelu``'s default) into the
LM's embedding space and are prepended to the text embeddings.  The loss
counts text positions only.  The decode is the decoder-only LM's (the
image tokens live in the KV cache).  For internvl2-26b a forward makes
2 ``rms_norm``, 96 ``rms_norm_residual`` and 48 ``flash_attention``
calls.

Under ``Runtime.rules`` on a rank mesh the backbone is the dense
family's (:mod:`~repro_torch.models.transformer`); the projector's
weights, whole on ``"model"``, have their ``"data"`` blocks gathered
before use.  A vocabulary that does not divide the ``"model"`` ranks
(internvl2-26b's 92,553) stays whole there (``layers.spec_to_pspec``),
and the embedding, the unembedding and the loss then take it whole.
Over a combined sequence that ``Runtime.on_sequence`` splits, the
sequence [patches; text] is built whole on every rank and each rank
takes its rows of it (``layers.split_seq``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.runtime import Runtime
from repro_torch.precision import compute

PyTree = Any


def _projector_specs(cfg: ModelConfig) -> Dict[str, Any]:
    v = cfg.vlm
    return {
        "norm": layers.norm_specs(v.vision_dim),
        "w1": ParamSpec((v.vision_dim, cfg.d_model), (None, "fsdp_embed")),
        "w2": ParamSpec((cfg.d_model, cfg.d_model), (None, "fsdp_embed")),
    }


def vlm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = transformer.lm_specs(cfg)
    specs["projector"] = _projector_specs(cfg)
    return specs


def project_patches(params: PyTree, cfg: ModelConfig,
                    patches: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Patch embeddings (B, P, vision_dim) -> (B, P, d) in the weights'
    dtype."""
    p = layers.gather_fsdp(params["projector"], _projector_specs(cfg), rt)
    x = rt.op("rms_norm")(patches.to(p["w1"].dtype), p["norm"]["scale"],
                          cfg.norm_eps)
    x = x @ p["w1"]
    x = torch.nn.functional.gelu(compute(x), approximate="tanh").to(x.dtype)
    return x @ p["w2"]


def _on_combined(cfg: ModelConfig, batch: Dict[str, Any],
                 rt: Runtime) -> Runtime:
    """``rt`` on the combined sequence of ``batch``'s patches and text."""
    return rt.on_sequence(batch["patches"].shape[1] +
                          batch["tokens"].shape[1], cfg)


def _embed(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
           rt: Runtime) -> torch.Tensor:
    """The combined sequence [projected patches; text embeddings], built
    whole, then this rank's rows of it where ``rt`` (on the combined
    sequence, :func:`_on_combined`) splits it."""
    whole = dataclasses.replace(rt, seq_split=False, seq_rows=False)
    vis = project_patches(params, cfg, batch["patches"], whole)
    txt = transformer.embed(params, cfg, batch["tokens"], whole)
    return layers.split_seq(torch.cat([vis, txt], dim=1), rt)


def vlm_loss(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
             rt: Runtime) -> torch.Tensor:
    """batch: patches (B, P, vision_dim), tokens (B, S_text), optionally
    mask (B, S_text).  Text token t is predicted from combined position
    P + t - 1; the mask is not shifted (as in the reference).  Returns
    the float32 cross entropy (plus the MoE aux loss of an MoE
    backbone)."""
    tokens = batch["tokens"]
    rt = _on_combined(cfg, batch, rt)
    x, y, aux = transformer._stack(params, cfg, _embed(params, cfg, batch,
                                                       rt), rt)
    h, _ = layers.open_norm(rt, y, x, params["final_norm"]["scale"],
                            cfg.norm_eps)
    n_p = batch["patches"].shape[1]
    loss = transformer.next_token_loss(params, cfg, h, tokens,
                                       batch.get("mask"), rt,
                                       slice(n_p - 1, -1))
    return loss if aux is None else loss + aux


def prefill(params: PyTree, cfg: ModelConfig, batch: Dict[str, Any],
            rt: Runtime, cache: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multimodal prefill over the P + S_text combined positions: (the
    last position's logits (B, V), the KV cache), in the preallocated
    form of :func:`repro_torch.models.transformer.prefill`."""
    rt = _on_combined(cfg, batch, rt)
    return transformer.prefill_embedded(params, cfg,
                                        _embed(params, cfg, batch, rt), rt,
                                        cache)


# decode: the decoder-only LM's (the image tokens are in the cache)
decode_step = transformer.decode_step
