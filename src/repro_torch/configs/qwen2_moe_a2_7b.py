"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936; 4 shared + 60 routed top-4.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 60 routed experts are padded to 64 slots (``ep_pad_to``), as in the
reference, where the expert axis must divide a 16-way mesh axis; the pad
slots never route (:mod:`repro_torch.models.moe`).
"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
        moe=MoEConfig(n_routed=60, top_k=4, n_shared=4, d_ff_expert=1408,
                      ep_pad_to=64),
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("qwen2-moe-a2.7b", build)
