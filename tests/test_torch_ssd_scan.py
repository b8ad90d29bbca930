"""The SSD-scan kernel's plain version against the reference.

On the CPU :func:`repro_torch.kernels.ops.ssd_scan` runs the plain version,
the port's ``models.ssm.ssd_chunked`` (the CUDA kernel is held against it
on the card by ``chip_smoke.py``).  Oracles:

* ``ssd_scan_pallas`` (the TPU kernel, in interpret mode, through
  ``repro.kernels.ops.ssd_scan``) at the ``tests/test_kernels.py`` shapes,
  with that file's bars: y 1e-4 (float32) / 5e-2 (bfloat16), state 1e-3;
* the definitional step-by-step recurrence, the port's own
  ``ssd_decode_step`` and the reference's, at 1e-4 in float32.

Inputs come from seeded numpy generators; ``a_log``, ``d_skip`` and
``dt_bias`` are drawn, not left at their inits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import ssm as ref_ssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sc
from repro_torch.models import ssm
from repro_torch.models.runtime import Runtime

pytestmark = pytest.mark.fast

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(b, s, h, p, n, g, seed):
    """x, dt, a_log, b, c, d_skip, dt_bias as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, h, p)).astype(f),
            (0.5 * rng.normal(size=(b, s, h))).astype(f),
            rng.uniform(-1.0, 0.5, size=h).astype(f),
            (0.3 * rng.normal(size=(b, s, g, n))).astype(f),
            (0.3 * rng.normal(size=(b, s, g, n))).astype(f),
            rng.uniform(0.0, 1.0, size=h).astype(f),
            rng.uniform(-0.5, 0.5, size=h).astype(f))


def _jax(arrays, jdt):
    """x, b, c in the working dtype; dt and the per-head vectors float32
    (as tests/test_kernels.py draws them)."""
    return [jnp.asarray(a).astype(jdt) if i in (0, 3, 4) else jnp.asarray(a)
            for i, a in enumerate(arrays)]


def _torch(arrays, tdt):
    return [torch.from_numpy(a).to(tdt) if i in (0, 3, 4)
            else torch.from_numpy(a) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (1, 64, 2, 16, 16, 1, 16),
    (2, 128, 4, 32, 64, 2, 32),
    (1, 96, 2, 64, 128, 1, 32),
])
def test_matches_the_tpu_kernel(b, s, h, p, n, g, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, p, n, g, seed=s + p)
    y_want, st_want = ref_ops.ssd_scan(*_jax(arrays, jdt), chunk)
    y_got, st_got = ops.ssd_scan(*_torch(arrays, tdt), chunk)
    assert y_got.shape == (b, s, h, p) and y_got.dtype == tdt
    assert st_got.shape == (b, h, p, n) and st_got.dtype == torch.float32
    np.testing.assert_allclose(y_got.float().numpy(),
                               np.asarray(y_want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(st_got.numpy(), np.asarray(st_want),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunked_matches_the_sequential_recurrence(chunk):
    """The port's chunked plain version == its own step-by-step
    recurrence == the reference's, in float32 (groups of 2 heads)."""
    arrays = _inputs(2, 48, 4, 8, 16, 2, seed=chunk)
    t = _torch(arrays, torch.float32)
    y_c, st_c = ops.ssd_scan(*t, chunk)
    y_s, st_s = ref.ssd_sequential_ref(*t)
    np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_c.numpy(), st_s.numpy(), rtol=1e-4,
                               atol=1e-4)
    y_r, st_r = ref_kernels.ssd_sequential_ref(*_jax(arrays, jnp.float32))
    np.testing.assert_allclose(y_s.numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_s.numpy(), np.asarray(st_r), rtol=1e-4,
                               atol=1e-4)


def test_decode_step_and_segsum_match_the_reference():
    rng = np.random.default_rng(11)
    arrays = _inputs(3, 1, 4, 8, 16, 2, seed=12)
    state = rng.normal(size=(3, 4, 8, 16)).astype(np.float32)
    x, dt, a_log, b, c, d_skip, dt_bias = arrays
    args = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d_skip, dt_bias,
            state)
    y_r, st_r = ref_ssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    y_p, st_p = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st_p.numpy(), np.asarray(st_r), rtol=1e-5,
                               atol=1e-5)
    v = rng.normal(size=(2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(torch.from_numpy(v)).numpy(),
                               np.asarray(ref_ssm._segsum(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)


def test_init_state_continues_a_split_sequence():
    """Scanning [0, S) from zero equals scanning [S/2, S) from the state
    after [0, S/2)."""
    t = _torch(_inputs(1, 64, 2, 16, 16, 1, seed=13), torch.float32)
    x, dt, a_log, b, c, d_skip, dt_bias = t
    y, st = ssm.ssd_chunked(*t, 16)
    _, st_half = ssm.ssd_chunked(x[:, :32], dt[:, :32], a_log, b[:, :32],
                                 c[:, :32], d_skip, dt_bias, 16)
    y2, st2 = ssm.ssd_chunked(x[:, 32:], dt[:, 32:], a_log, b[:, 32:],
                              c[:, 32:], d_skip, dt_bias, 16,
                              init_state=st_half)
    np.testing.assert_allclose(y2.numpy(), y[:, 32:].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st2.numpy(), st.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_refuses_gradients_and_bad_inputs():
    """The wrapper gives a gradient (the plain version's) and refuses bad
    inputs.  The gradients of every input through y and the final state,
    under seeded cotangents, against ``jax.grad`` of the reference's
    ``ssd_chunked`` (its XLA path): 1e-4 (float32, the SSD bar)."""
    arrays = _inputs(1, 32, 2, 16, 16, 1, seed=14)
    rng = np.random.default_rng(15)
    cot_y = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    cot_s = rng.normal(size=(1, 2, 16, 16)).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, st = ops.ssd_scan(*t, 16)
    grads = torch.autograd.grad((y, st), t, (torch.from_numpy(cot_y),
                                             torch.from_numpy(cot_s)))

    def ref_fn(*xs):
        y_, st_ = ref_ssm.ssd_chunked(*xs, 16)
        return jnp.sum(y_ * cot_y) + jnp.sum(st_ * cot_s)

    want = jax.grad(ref_fn, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in arrays))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    t = _torch(arrays, torch.float32)
    x, dt, a_log, b, c, d_skip, dt_bias = t
    with pytest.raises(ValueError, match="dividing"):
        ops.ssd_scan(x, dt, a_log, b, c, d_skip, dt_bias, 12)
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_scan(x, dt, a_log, torch.zeros(1, 32, 3, 16),
                     torch.zeros(1, 32, 3, 16), d_skip, dt_bias, 16)
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_scan(x, dt[:, :, :1], a_log, b, c, d_skip, dt_bias, 16)
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        ops.ssd_scan(x, dt, a_log, b.double(), c.double(), d_skip, dt_bias,
                     16)
    with pytest.raises(ValueError, match="no ssd_scan"):
        sc.ssd_scan(*(v.to("meta") for v in (x, dt, a_log, b, c, d_skip,
                                              dt_bias)), 16)
    before = sc.LAUNCHES
    got = Runtime().op("ssd_scan")(x, dt, a_log, b, c, d_skip, dt_bias, 16)
    want = Runtime(kernels="plain").op("ssd_scan")(x, dt, a_log, b, c,
                                                   d_skip, dt_bias, 16)
    assert sc.LAUNCHES == before
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
    assert ops.launch_counts()["ssd_scan"] == sc.LAUNCHES
