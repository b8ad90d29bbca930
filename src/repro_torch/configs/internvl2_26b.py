"""internvl2-26b [vlm] — InternViT (stub) + InternLM2-20B backbone:
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
[arXiv:2404.16821; hf]

The vision frontend is a stub, as in the reference: the inputs are
precomputed patch embeddings (256 patches at InternViT-6B's width 3200);
the projector and the LM backbone are real.
"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, VLMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553, head_dim=128,
        rope_theta=1e6,
        vlm=VLMConfig(n_patches=256, vision_dim=3200),
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("internvl2-26b", build)
