"""Architecture configs the port serves (published hyperparameters).

Importing this package registers every architecture with
:mod:`repro_torch.models.registry`.  One module per architecture; these
are the dense family's four.  ``qwen2-72b`` does not fit on one card and
is registered, not run.
"""

from repro_torch.configs import (qwen1_5_0_5b, qwen2_1_5b, qwen2_72b,
                                 qwen3_1_7b)

__all__ = ["qwen1_5_0_5b", "qwen2_1_5b", "qwen2_72b", "qwen3_1_7b"]
