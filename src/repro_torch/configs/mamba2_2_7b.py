"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, ssm_state=128,
vocab=50280; SSD (state-space duality).  [arXiv:2405.21060; unverified]

The port runs its full-sequence forward (``loss_fn``, also its prefill)
and its one-token decode (``decode_fn``, the serve plane).
"""

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, SSMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280, head_dim=64,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    )


registry.register("mamba2-2.7b", build)
