"""The int8 quantize/dequantize kernels' plain versions against the
reference.

On the CPU :func:`repro_torch.kernels.ops.quantize` and ``dequantize`` run
the plain versions (the CUDA kernels are held against them bit for bit on
the card by ``chip_smoke.py``).  Oracles from the JAX package:
``quantize_pallas`` / ``dequantize_pallas`` (the TPU kernels, in
interpret mode), the numpy ``_ref_quant`` of
``tests/test_quantize_kernel.py``, and ``gradsync._quantize_int8`` (the
reference's in-graph quantizer, one scale for the whole input).

The port computes the scale as written, ``max(absmax, 1e-12) / 127`` with
an IEEE float32 division, and equals the numpy oracle exactly.  The JAX
functions, compiled by XLA, multiply by the float32 reciprocal of 127
instead (XLA rewrites a division by a constant), which puts some scales
one ulp away from the division's; where a block's scale agrees its int8
values agree exactly, and where it is one ulp off a value may differ by
one (the reference test's own allowance).  Inputs come from seeded numpy
generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradsync as ref_gradsync
from repro.kernels.quantize import dequantize_pallas, quantize_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qz
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ref_quant(x, block):
    """tests/test_quantize_kernel.py's numpy oracle."""
    xb = np.asarray(x, np.float32).reshape(-1, block)
    scales = np.maximum(np.abs(xb).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.round(xb / scales[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1), scales


def _match_compiled(q, s, qj, sj, block):
    """The port against an XLA-compiled reference: scales within one
    float32 ulp; q equal in every block whose scale is equal, within 1
    elsewhere.  Returns the number of blocks whose scale differs."""
    s, sj = s.numpy(), np.asarray(sj).reshape(-1)
    np.testing.assert_array_max_ulp(s, sj, maxulp=1)
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    dq = dq.reshape(-1, block)
    same = s == sj
    assert not dq[same].any()
    assert dq.max(initial=0) <= 1
    return int((~same).sum())


def _input(n, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(
        np.float32)


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(x).astype(jdt)
    # the torch input holds exactly the jax input's values
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("n,block", [(2048, 2048), (8192, 2048),
                                     (4096, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_matches_the_tpu_kernel_and_numpy_exactly(n, block, dtype):
    """Exactly the numpy oracle; the TPU kernel as ``_match_compiled``
    says; dequantize exactly the TPU kernel's on the same (q, scales)."""
    xj, xt = _both(_input(n, seed=n + block), dtype)
    q, s = ops.quantize(xt, block)
    qj, sj = quantize_pallas(xj, block=block)
    qn, sn = _ref_quant(np.asarray(xj.astype(jnp.float32)), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)
    _match_compiled(q, s, qj, sj, block)
    back = ops.dequantize(q, s, block, DTYPES[dtype][1])
    back_j = dequantize_pallas(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               block=block, out_dtype=DTYPES[dtype][0])
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(back_j.astype(jnp.float32)))


@pytest.mark.parametrize("case", range(6))
def test_roundtrip_error_bounded(case):
    """|dequantize(quantize(x)) - x| <= scale / 2 per element, over
    magnitudes spanning four decades (the reference test's bound)."""
    rng = np.random.default_rng(33_100 + case)
    nblocks = int(rng.integers(1, 9))
    block = 512
    x = _input(nblocks * block, seed=case,
               scale=float(10.0 ** rng.uniform(-2, 2)))
    q, s = ops.quantize(torch.from_numpy(x), block)
    back = ops.dequantize(q, s, block).numpy()
    absmax = np.abs(x).reshape(nblocks, block).max(axis=1)
    bound = np.repeat(absmax / 127.0, block) * 0.5 + 1e-9
    assert np.all(np.abs(back - x) <= bound + 1e-6)
    qn, sn = _ref_quant(x, block)
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)
    qj, sj = quantize_pallas(jnp.asarray(x), block=block)
    _match_compiled(q, s, qj, sj, block)


def test_zero_input_is_exact():
    x = torch.zeros(2048)
    q, s = ops.quantize(x, 2048)
    assert torch.equal(ops.dequantize(q, s, 2048), x)
    qj, sj = quantize_pallas(jnp.zeros((2048,), jnp.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_ties_round_half_to_even():
    """A block with absmax 127 has scale 1: every .5 rounds to even."""
    x = np.concatenate([[127.0], np.arange(-254, 254) / 2,
                        np.zeros(3)]).astype(np.float32)
    q, s = ops.quantize(torch.from_numpy(x), 512)
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.round(x).astype(np.int8))
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(quantize_pallas(
                                      jnp.asarray(x), block=512)[0]))


@pytest.mark.parametrize("n", [2048, 3000, 4096 * 3])
def test_block_of_the_whole_input_is_the_gradsync_quantizer(n):
    """``block = n`` is the reference's in-graph ``_quantize_int8`` (one
    scale per worker shard) — the call the port's compressed reduction
    makes — up to XLA's reciprocal (``_match_compiled``), and exactly the
    numpy oracle."""
    x = _input(n, seed=n, scale=7.0)
    q, s = ops.quantize(torch.from_numpy(x), n)
    q_g, s_g = ref_gradsync._quantize_int8(jnp.asarray(x))
    _match_compiled(q, s, q_g, s_g, n)
    qn, sn = _ref_quant(x, n)
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)


def test_wrappers_check_inputs_and_count_nothing_on_the_cpu():
    x = torch.from_numpy(_input(4096, seed=5))
    before = ops.launch_counts()
    assert Runtime().op("quantize") is ops.quantize
    assert Runtime(kernels="plain").op("dequantize") is qz.dequantize_plain
    q, s = Runtime(kernels="plain").op("quantize")(x, 1024)
    q2, s2 = ops.quantize(x, 1024)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert ops.launch_counts() == before
    assert {"quantize", "dequantize"} <= set(before)
    assert ref.quantize_ref is qz.quantize_plain
    assert ref.dequantize_ref is qz.dequantize_plain
    with pytest.raises(ValueError, match="dividing"):
        ops.quantize(x, 1000)
    with pytest.raises(ValueError, match="flat"):
        ops.quantize(x.view(4, 1024), 1024)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.quantize(x.double(), 1024)
    with pytest.raises(ValueError, match="scales must be"):
        ops.dequantize(q, s[:2], 1024)
    with pytest.raises(TypeError, match="int8"):
        ops.dequantize(q.int(), s, 1024)
    with pytest.raises(TypeError, match="writes float32 or bfloat16"):
        ops.dequantize(q, s, 1024, torch.float16)
    with pytest.raises(ValueError, match="no quantize"):
        qz.quantize(x.to("meta"), 1024)
