"""The RMSNorm kernels' plain versions against the reference.

On the CPU :func:`repro_torch.kernels.ops.rms_norm` and
``rms_norm_residual`` run the plain versions (the Triton kernels are held
against them on the card by ``chip_smoke.py``).  The oracles are the TPU
kernels ``rms_norm_pallas`` / ``rms_norm_residual_pallas`` in interpret
mode, through ``repro.kernels.ops``, at the repo's kernel bars: float32
2e-5, bfloat16 2e-2.  The residual form normalises the float32 sum, as
the TPU kernel does, so it is held against that kernel and not against
``ref.rms_norm_residual_ref`` (which normalises the rounded sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# the decoder's shapes at small size: (T, d) hidden rows, (T*H, D) heads,
# and a leading-dims input
SHAPES = [(8, 128), (8 * 4, 32), (3, 2048), (2, 1, 96), (5, 200)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.2, size=shape[-1:]).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rms_norm_matches_the_tpu_kernel(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    x, _, w = _inputs(shape, seed=sum(shape))
    want = ref_ops.rms_norm(jnp.asarray(x).astype(jdt),
                            jnp.asarray(w).astype(jdt), 1e-6)
    got = ops.rms_norm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(w).to(tdt), 1e-6)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # and the model's plain norm, which the reference decoder uses
    plain = ref_layers.rms_norm(jnp.asarray(x).astype(jdt),
                                jnp.asarray(w).astype(jdt), 1e-6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(plain, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rms_norm_residual_matches_the_tpu_kernel(dtype, shape):
    jdt, tdt, tol = DTYPES[dtype]
    x, res, w = _inputs(shape, seed=3 * sum(shape))
    want_o, want_r = ref_ops.rms_norm_residual(
        jnp.asarray(x).astype(jdt), jnp.asarray(res).astype(jdt),
        jnp.asarray(w).astype(jdt), 1e-6)
    got_o, got_r = ops.rms_norm_residual(
        torch.from_numpy(x).to(tdt), torch.from_numpy(res).to(tdt),
        torch.from_numpy(w).to(tdt), 1e-6)
    for got, want in ((got_o, want_o), (got_r, want_r)):
        assert got.dtype == tdt and got.shape == shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    x = torch.ones(4, 8)
    rn.reset_launch_counts()
    rn.rms_norm(x, torch.ones(8))
    rn.rms_norm_residual(x, x, torch.ones(8))
    assert rn.launch_counts() == {"rms_norm": 0, "rms_norm_residual": 0}
    with pytest.raises(ValueError, match="width"):
        rn.rms_norm(x, torch.ones(6))
    with pytest.raises(ValueError, match="weight"):
        rn.rms_norm(x, torch.ones(2, 8))
    with pytest.raises(TypeError, match="share"):
        rn.rms_norm_residual(x, x.bfloat16(), torch.ones(8))
    with pytest.raises(ValueError, match="differ"):
        rn.rms_norm_residual(x, torch.ones(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="no rms_norm for device"):
        rn.rms_norm(x.to("meta"), torch.ones(8, device="meta"))


@pytest.mark.parametrize("d,block,warps", [(1, 1, 1), (96, 128, 1),
                                           (128, 128, 1), (2048, 2048, 8),
                                           (6144, 8192, 16)])
def test_launch_shape(d, block, warps):
    assert rn._launch_shape(d) == (block, warps)
