"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; GQA, QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("qwen2-72b", build)
