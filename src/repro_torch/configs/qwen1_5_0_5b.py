"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936; QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab_size=151936, head_dim=64,
        qkv_bias=True, rope_theta=1e4, tie_embeddings=True,
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("qwen1.5-0.5b", build)
