"""Architecture configs the port runs (published hyperparameters).

Importing this package registers every architecture with
:mod:`repro_torch.models.registry`.  One module per architecture, the
reference's ten model configs: the dense family's four, the moe
family's qwen2-moe-a2.7b and deepseek-moe-16b, the ssm family's
mamba2-2.7b, the hybrid family's zamba2-2.7b, the vlm family's
internvl2-26b and the encdec family's seamless-m4t-medium.
``qwen2-72b`` does not fit on one card and is registered, not run.
"""

from repro_torch.configs import (deepseek_moe_16b, internvl2_26b,
                                 mamba2_2_7b, qwen1_5_0_5b, qwen2_1_5b,
                                 qwen2_72b, qwen2_moe_a2_7b, qwen3_1_7b,
                                 seamless_m4t_medium, zamba2_2_7b)

__all__ = ["deepseek_moe_16b", "internvl2_26b", "mamba2_2_7b",
           "qwen1_5_0_5b", "qwen2_1_5b", "qwen2_72b", "qwen2_moe_a2_7b",
           "qwen3_1_7b", "seamless_m4t_medium", "zamba2_2_7b"]
