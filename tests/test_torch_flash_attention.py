"""The flash-attention kernel's plain version against the reference.

On the CPU :func:`repro_torch.kernels.ops.flash_attention` runs the plain
version (the CUDA kernel is held against it on the card by
``chip_smoke.py``).  Oracles from the JAX package:

* ``flash_attention_flat`` (the TPU kernel, in interpret mode, through
  ``repro.kernels.ops.flash_attention``) at the ``tests/test_kernels.py``
  shapes and at S = 200, which its wrapper pads to 256;
* ``ref.flash_attention_ref`` (the pure-jnp oracle) and the model's
  ``attention._sdpa``, for the non-causal unpadded case, where the TPU
  kernel counts its zero-padded keys in the softmax (ROADMAP.md §3).

Tolerances are the repo's kernel bars: float32 2e-5, bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import attention as ref_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 4, 4, 64),
    (2, 256, 4, 2, 64),
    (1, 384, 8, 1, 128),   # MQA
    (2, 128, 6, 2, 32),    # a group of 3
])
def test_matches_the_tpu_kernel(b, s, hq, hkv, d, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, s, hq, hkv, d,
                                               seed=s + hq), dtype)
    want = ref_ops.flash_attention(jq, jk, jv, causal=causal)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, s, hq, d) and got.dtype == tq.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unpadded_causal_matches_the_tpu_kernel(dtype):
    """S = 200 is no multiple of the TPU kernel's 128 tiles: its wrapper
    pads, the port takes the sequence as it is."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 200, 4, 2, 64, seed=7),
                                       dtype)
    want = ref_ops.flash_attention(jq, jk, jv, causal=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want,
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unpadded_non_causal_matches_the_oracles(dtype):
    """Non-causal at S = 200 against the jnp oracle and ``_sdpa``; the
    TPU kernel's padded keys (zeros) would enter its softmax here, so it
    is shown to differ and is not the oracle."""
    b, s, hq, hkv, d = 1, 200, 4, 2, 64
    arrays = _inputs(b, s, hq, hkv, d, seed=8)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    flat = [x.transpose(0, 2, 1, 3).reshape(-1, s, d) for x in (jq, jk, jv)]
    want = ref_kernels.flash_attention_ref(*flat, group=hq // hkv,
                                           causal=False)
    want = want.reshape(b, hq, s, d).transpose(0, 2, 1, 3)
    _close(got, want, DTYPES[dtype][2])
    if dtype == "float32":
        _close(got, ref_attention._sdpa(jq, jk, jv, causal=False), 2e-5)
        padded = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=False))
        assert np.abs(padded - got.numpy()).max() > 1e-2


def test_strided_inputs_and_the_runtime_sites():
    """k/v as views of one fused projection (no copy), and the kernel and
    plain sites of the Runtime agree on the CPU."""
    rng = np.random.default_rng(9)
    b, s, hq, hkv, d = 2, 70, 6, 2, 32
    q = torch.from_numpy(rng.normal(size=(b, s, hq, d)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(b, s, 2, hkv, d))
                          .astype(np.float32))
    k, v = kv[:, :, 0], kv[:, :, 1]
    assert not k.is_contiguous()
    got = Runtime().op("flash_attention")(q, k, v, True)
    want = Runtime(kernels="plain").op("flash_attention")(
        q, k.contiguous(), v.contiguous(), True)
    assert torch.equal(got, want)
    _close(got, ref_attention._sdpa(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()), causal=True),
           2e-5)
    assert ref.flash_attention_ref is fa.flash_attention_plain


def test_wrapper_refuses_gradients_and_bad_inputs():
    """The wrapper gives a gradient (the plain version's, the gradient the
    reference takes of its XLA attention) and refuses bad inputs.  The
    gradient of q, k and v against ``jax.grad`` of the reference's
    ``_sdpa`` under one seeded cotangent: 2e-5 (float32)."""
    arrays = _inputs(1, 24, 4, 2, 32, seed=41)
    cot = np.random.default_rng(42).normal(size=(1, 24, 4, 32)).astype(
        np.float32)
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ops.flash_attention(*qkv)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(cot))
    want = jax.grad(lambda q, k, v: jnp.sum(
        ref_attention._sdpa(q, k, v, causal=True) * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    for g, w in zip(grads, want):
        _close(g, w, 2e-5)
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 32),
                            torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="does not fit"):
        ops.flash_attention(q, torch.zeros(1, 9, 2, 32),
                            torch.zeros(1, 9, 2, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="no flash_attention"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    before = fa.LAUNCHES
    ops.flash_attention(q, k, k)
    assert fa.LAUNCHES == before       # the plain version counts nothing
    assert "flash_attention" in ops.launch_counts()
