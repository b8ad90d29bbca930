"""seamless-m4t-medium [audio] — enc-dec, 12L+12L d_model=1024 16H
(kv=16) d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_src, d_model).  Deviations kept from
the reference: RoPE and RMSNorm in place of sinusoidal positions and
LayerNorm.
"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import EncDecConfig, ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=256206, head_dim=64,
        rope_theta=1e4,
        encdec=EncDecConfig(n_encoder_layers=12, n_decoder_layers=12),
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("seamless-m4t-medium", build)
