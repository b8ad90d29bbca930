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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [
    (1, 64, 4, 64, 64, 1, 32),     # zamba2-2.7b's (P, N)
    (1, 96, 4, 48, 32, 2, 32),     # P no power-of-two multiple of 16
])
def test_new_kernel_shapes_match_the_reference(b, s, h, p, n, g, chunk,
                                               dtype):
    """The plain version at shapes the kernels now take, against
    ``repro.kernels.ops.ssd_scan`` (its Pallas kernel in interpret mode),
    at the tests/test_kernels.py bars."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, p, n, g, seed=7 * p + n)
    y_want, st_want = ref_ops.ssd_scan(*_jax(arrays, jdt), chunk)
    y_got, st_got = ops.ssd_scan(*_torch(arrays, tdt), chunk)
    np.testing.assert_allclose(y_got.float().numpy(),
                               np.asarray(y_want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(st_got.numpy(), np.asarray(st_want),
                               rtol=1e-3, atol=1e-3)


def test_kernel_shape_rule_takes_zamba2():
    """The kernels' shape rule: P and N multiples of 16 up to 128 and 256,
    any chunk up to 4096; zamba2-2.7b's (64, 64), mamba2-2.7b's (64, 128)
    and the reference tests' shapes are in, others raise naming the
    rule."""
    from repro.configs import mamba2_2_7b, zamba2_2_7b
    for cfg in (zamba2_2_7b.build(), mamba2_2_7b.build()):
        assert sc.kernel_shape_ok(cfg.ssm.head_dim, cfg.ssm.d_state,
                                  cfg.ssm.chunk)
    for p, n in ((16, 16), (32, 64), (64, 128), (48, 32), (128, 256)):
        assert sc.kernel_shape_ok(p, n, 256)
    for p, n, chunk in ((24, 16, 64), (16, 264, 64), (144, 16, 64),
                        (64, 64, 4097)):
        assert not sc.kernel_shape_ok(p, n, chunk)
    with pytest.raises(ValueError, match="multiple of 16"):
        sc.check_kernel_shape(24, 16, 64)


def test_workspace_layout_parts_are_aligned_and_disjoint():
    """One buffer holds y, the state and the four steps' intermediates,
    each 256-byte aligned, none overlapping; the scores' tiles are the
    chunk rounded up to 64."""
    for dtype in (torch.float32, torch.bfloat16):
        layout = sc.workspace_layout(2, 300, 4, 48, 32, 2, 100, dtype)
        total = layout.pop("total")[0]
        assert list(layout) == ["y", "state", "scores", "cs", "dts", "w",
                                "local", "s_in"]
        assert layout["scores"][1] == (2, 3, 2, 128, 128)
        assert layout["y"][2] == layout["s_in"][2] == dtype
        spans = sorted((off, off + sc._bytes(shape, dt))
                       for off, shape, dt in layout.values())
        assert all(off % 256 == 0 for off, _ in spans)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= total


class _FakeLib:
    """Records the packed arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def ssd_scan_launch(self, args):
        self.calls.append(list(args))
        return 0


def test_launch_packs_every_argument(monkeypatch):
    """The wrapper's launch path on CPU tensors with a stand-in library:
    one allocation whose parts sit where the packed pointers say, the
    strides of x, dt, b and c as given, dt's own dtype, and a contiguous
    copy of an operand whose rows are not 16-byte aligned."""
    lib = _FakeLib()
    monkeypatch.setattr(sc, "_caller",
                        lambda: ([0] * sc._N_ARGS, lib.ssd_scan_launch))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 7, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    b, s, h, p, n, g, chunk = 1, 64, 4, 32, 16, 2, 32
    t = _torch(_inputs(b, s, h, p, n, g, seed=5), torch.bfloat16)
    x, dt, a_log, bb, cc, d_skip, dt_bias = t
    wide = torch.zeros(b, s, g * n + 3, dtype=torch.bfloat16)
    c_odd = wide[..., 3:].view(b, s, g, n)       # rows 6 bytes off
    before = sc.LAUNCHES
    y, st = sc._launch(x, dt.bfloat16(), a_log, bb, c_odd, d_skip, dt_bias,
                       chunk)
    args = lib.calls[-1]
    assert sc.LAUNCHES == before + 1
    assert args[15:24] == [b, s, h, g, p, n, chunk, 1, 1]
    assert args[24:27] == list(x.stride()[:3])
    assert args[30:33] == list(bb.stride()[:3])
    assert args[33:36] == [s * g * n, g * n, n]   # the copy, contiguous
    assert args[4] != c_odd.data_ptr() and args[36] == 7
    layout = sc.workspace_layout(b, s, h, p, n, g, chunk, torch.bfloat16)
    assert args[7] == y.data_ptr() and args[8] == st.data_ptr()
    assert args[9] - args[7] == layout["scores"][0]
    assert args[12] - args[7] == layout["w"][0]
    assert args[14] - args[7] == layout["s_in"][0]
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    with pytest.raises(ValueError, match="multiple of 16"):
        sc._launch(x[..., :24], dt, a_log, bb, cc, d_skip, dt_bias, chunk)


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
