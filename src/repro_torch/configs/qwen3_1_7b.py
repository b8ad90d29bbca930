"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=6144, vocab_size=151936, head_dim=128,
        qkv_bias=False, qk_norm=True, rope_theta=1e6,
        tie_embeddings=True,
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("qwen3-1.7b", build)
