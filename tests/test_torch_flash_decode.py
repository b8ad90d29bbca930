"""The flash-decode kernel's plain version against the reference.

On the CPU :func:`repro_torch.kernels.ops.flash_decode` runs the plain
version (the CUDA kernel is held against it on the card by
``chip_smoke.py``).  Two oracles from the JAX package:

* ``flash_decode_flat`` (the TPU kernel, in interpret mode, through
  ``repro.kernels.ops.flash_decode``) with a scalar length;
* ``models.attention._sdpa(q_offset=pos, kv_len=pos + 1)``, the function
  the reference's serve decode computes, with a per-row length.

Tolerances are the repo's kernel bars: float32 2e-5, bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attention
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


def _port(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len", [
    (2, 40, 4, 2, 64, 1), (2, 40, 4, 2, 64, 17), (1, 40, 8, 8, 128, 40),
    (3, 520, 16, 8, 128, 513), (2, 33, 6, 1, 64, 33)])
def test_scalar_length_matches_the_tpu_kernel(dtype, b, s, hq, hkv, d,
                                              kv_len):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=b * s + kv_len)
    want = ref_ops.flash_decode(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                                kv_len)
    got = ops.flash_decode(_port(q, tdt), _port(k, tdt), _port(v, tdt),
                           torch.tensor(kv_len))
    assert got.dtype == tdt and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (4, 48, 4, 2, 32), (8, 64, 16, 8, 128), (3, 30, 12, 2, 64)])
def test_per_row_lengths_match_the_serve_decode_oracle(dtype, b, s, hq,
                                                       hkv, d):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=7 * b + d)
    pos = np.random.default_rng(b).integers(0, s, size=b).astype(np.int32)
    pos[0] = 0                           # a row with one valid position
    pos[-1] = s - 1                      # and one with all of them
    want = ref_attention._sdpa(
        _jax(q, jdt)[:, None], _jax(k, jdt), _jax(v, jdt), causal=False,
        q_offset=jnp.asarray(pos), kv_len=jnp.asarray(pos + 1))[:, 0]
    got = ops.flash_decode(_port(q, tdt), _port(k, tdt), _port(v, tdt),
                           torch.from_numpy(pos + 1))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_strided_cache_view_and_untouched_tail():
    """The cache is read through its strides (a layer slice of a stacked
    cache), and positions at or beyond a row's length never matter."""
    q, k, v = _inputs(2, 16, 4, 2, 64, seed=11)
    stacked_k = torch.zeros((3,) + k.shape)
    stacked_v = torch.zeros((3,) + v.shape)
    stacked_k[1], stacked_v[1] = torch.from_numpy(k), torch.from_numpy(v)
    kv_len = torch.tensor([5, 16], dtype=torch.int32)
    got = ops.flash_decode(torch.from_numpy(q), stacked_k[1], stacked_v[1],
                           kv_len)
    stacked_k[1, 0, 5:] = 1e4            # garbage past row 0's length
    stacked_v[1, 0, 5:] = -1e4
    again = ops.flash_decode(torch.from_numpy(q), stacked_k[1],
                             stacked_v[1], kv_len)
    np.testing.assert_array_equal(got.numpy(), again.numpy())


def test_wrapper_checks_and_counts_no_cpu_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 4, 2, 32, 1))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    fd.reset_launch_counts()
    fd.flash_decode(q, k, v, lens)
    assert fd.launch_counts() == {"flash_decode": 0}
    with pytest.raises(ValueError, match="kv_len"):
        fd.flash_decode(q, k, v, lens.long())
    with pytest.raises(ValueError, match="does not fit"):
        fd.flash_decode(q[:, :3], k, v, lens)
    with pytest.raises(TypeError, match="share"):
        fd.flash_decode(q, k.double(), v.double(), lens)
    with pytest.raises(ValueError, match="differ"):
        fd.flash_decode(q, k, v[:, :4], lens)
    meta = [t.to("meta") for t in (q, k, v, lens)]
    with pytest.raises(ValueError, match="no flash_decode for device"):
        fd.flash_decode(*meta)
