"""Model configuration dataclasses for every architecture family.

One frozen dataclass tree describes an architecture completely; the
builders in :mod:`repro_torch.configs` instantiate the published
hyperparameters; ``reduced()`` shrinks any config to a CPU-testable size
while keeping its family.  The port runs the ``dense``, ``ssm`` and
``hybrid`` families; the other families' sub-configs are here as plain
data so every config loads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int                 # routed experts
    top_k: int
    n_shared: int = 0             # always-on shared experts
    d_ff_expert: int = 0          # per-expert FFN width
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3   # router z-loss
    aux_coef: float = 1e-2        # load-balance loss
    ep_pad_to: Optional[int] = None   # pad routed experts for EP divisibility


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                  # N (SSD state size)
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # SSD chunk length
    conv_width: int = 4
    n_groups: int = 1             # B/C groups (GVA)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6           # shared attention block period (Zamba2)
    n_shared_blocks: int = 1      # distinct shared transformer blocks


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    n_decoder_layers: int
    frontend_dim: int = 80        # stub: precomputed frame features dim


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256          # stub: precomputed patch embeddings
    vision_dim: int = 3200        # InternViT-6B width (projector input)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # which shapes this arch cannot run, with the reason
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Parameter count of the port's own specs (exact)."""
        from repro_torch.models import layers, registry  # avoids a cycle
        return sum(spec.numel() for spec in
                   layers.spec_leaves(registry.param_specs(self)))

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``reduced()`` presets): a hybrid keeps 4 layers at
        ``attn_every=2``, an ssm ``d_state=16, head_dim=16, chunk=32``."""
        changes = dict(
            n_layers=min(self.n_layers, 2 if self.hybrid is None else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_routed=8, top_k=2,
                n_shared=min(self.moe.n_shared, 2), d_ff_expert=64,
                ep_pad_to=None)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.encdec:
            changes["encdec"] = dataclasses.replace(
                self.encdec, n_encoder_layers=2, n_decoder_layers=2)
        if self.hybrid:
            changes["hybrid"] = dataclasses.replace(self.hybrid,
                                                    attn_every=2)
        if self.vlm:
            changes["vlm"] = dataclasses.replace(
                self.vlm, n_patches=8, vision_dim=64)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input shape x step kind) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
