"""Architecture configs the port runs (published hyperparameters).

Importing this package registers every architecture with
:mod:`repro_torch.models.registry`.  One module per architecture: the
dense family's four, the ssm family's mamba2-2.7b and the hybrid
family's zamba2-2.7b.  ``qwen2-72b`` does not fit on one card and is
registered, not run.
"""

from repro_torch.configs import (mamba2_2_7b, qwen1_5_0_5b, qwen2_1_5b,
                                 qwen2_72b, qwen3_1_7b, zamba2_2_7b)

__all__ = ["mamba2_2_7b", "qwen1_5_0_5b", "qwen2_1_5b", "qwen2_72b",
           "qwen3_1_7b", "zamba2_2_7b"]
