"""zamba2-2.7b [hybrid] — 54 Mamba2 blocks d_model=2560 + ONE shared
attention block (32H, kv=32, d_ff=10240) every 6 blocks; ssm_state=64;
vocab=32000.  [arXiv:2411.15242; hf]

The shared block consumes the running hidden state (no embedding concat
or per-invocation LoRA), the reference's simplification.  The port runs
its full-sequence forward, its decode and its training
(:mod:`repro_torch.train.steps`; the shared block's gradient sums over
its sites).
"""

from repro_torch.models import registry
from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        rope_theta=1e4,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
        hybrid=HybridConfig(attn_every=6),
    )


registry.register("zamba2-2.7b", build)
