"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; GQA, QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("qwen2-1.5b", build)
