"""The float64 yardstick of the port's plain path, on the CPU.

``chip_smoke.py`` phase 13 holds the kernels' float32 gradients against
the plain path's gradients in float64 (the weights cast up), beside the
plain path's own float32 gradients.  That needs every step of the plain
path to compute in float64 when the weights are float64
(:mod:`repro_torch.precision`).  Here, at the training tests' small
configs (``tests/test_torch_train.py``): no operation of the float64
step makes a float32 tensor, its loss and gradients are float64, and
they agree with the float32 plain step's (losses 1e-5 relative; each
gradient leaf within 1e-4 of its largest float64 entry, float32's
rounding through two layers).  Tokens from a seeded numpy generator.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import precision
from repro_torch import tree as tree_util
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.runtime import Runtime
from repro_torch.train import steps

pytestmark = pytest.mark.fast

CONFIGS = {
    "ssm": ModelConfig(name="train-ssm-test", family="ssm", n_layers=2,
                       d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
                       vocab_size=256, head_dim=16,
                       ssm=SSMConfig(d_state=16, head_dim=16, expand=2,
                                     chunk=8, n_groups=2)),
    "dense": ModelConfig(name="train-test", family="dense", n_layers=2,
                         d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                         vocab_size=256, head_dim=16, qk_norm=True,
                         tie_embeddings=True, rope_theta=1e6),
}
PLAIN = Runtime(gradsync="spindle", dp_workers=2, kernels="plain")


class _Float32Outputs(TorchDispatchMode):
    """Records every operation whose output holds a float32 tensor."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(o, torch.Tensor) and o.dtype == torch.float32
               for o in outs):
            self.seen.append(func.__name__)
        return out


def _inputs(family, dtype):
    """Weights from seed 0 (drawn in float32, cast to ``dtype``) and a
    batch of tokens for two workers."""
    arch = registry.Arch(CONFIGS[family])
    params = arch.init_params(0, "cpu", torch.float32)
    params = tree_util.map(lambda t: t.to(dtype), params)
    tokens = np.random.default_rng(58).integers(0, 256, size=(4, 32))
    return arch, params, {"tokens": torch.as_tensor(tokens,
                                                    dtype=torch.int32)}


def _step(arch, params, batch):
    """The plain path's per-worker losses and stacked gradients."""
    return steps.worker_grads(arch, PLAIN)(params, batch)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_the_float64_step_never_drops_to_float32(family):
    inputs = _inputs(family, torch.float64)
    with _Float32Outputs() as mode:
        losses, grads = _step(*inputs)
    assert mode.seen == []
    assert losses.dtype == torch.float64
    assert {g.dtype for g in tree_util.leaves(grads)} == {torch.float64}


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_the_float64_step_agrees_with_the_float32_plain_step(family):
    loss64, g64 = _step(*_inputs(family, torch.float64))
    loss32, g32 = _step(*_inputs(family, torch.float32))
    np.testing.assert_allclose(loss32.double().numpy(), loss64.numpy(),
                               rtol=1e-5, atol=0)
    for (path, a), y in zip(tree_util.paths(g32), tree_util.leaves(g64)):
        top = float(y.abs().max()) or 1.0
        err = float((a.double() - y).abs().max()) / top
        assert err <= 1e-4, (path, err)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, torch.float32),
                                        (torch.float32, torch.float32),
                                        (torch.float64, torch.float64)])
def test_compute_keeps_float64_and_widens_the_rest(dtype, want):
    t = torch.ones(3, dtype=dtype)
    assert precision.compute(t).dtype == want
    assert precision.compute_dtype(dtype) == want
