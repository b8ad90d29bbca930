"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400; 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]

Deviation kept from the reference: the published model has a dense FFN
in layer 0; here every layer is MoE, so the stack is homogeneous.
"""

from repro_torch.configs._common import FULL_ATTN_SKIP
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400, head_dim=128,
        rope_theta=1e4,
        moe=MoEConfig(n_routed=64, top_k=6, n_shared=2, d_ff_expert=1408),
        skip_shapes=FULL_ATTN_SKIP,
    )


registry.register("deepseek-moe-16b", build)
