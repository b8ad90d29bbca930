"""The RMSNorm kernels' plain versions against the reference.

On the CPU :func:`repro_torch.kernels.ops.rms_norm` and
``rms_norm_residual`` run the plain versions (the CUDA kernels are held
against them on the card by ``chip_smoke.py``; their launch geometry and
packed arguments are checked here).  The oracles are the TPU
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
    # meta tensors (the dry-run's) take the meta launch: an empty output
    # of the kernel's shape and dtype, nothing launched
    out = rn.rms_norm(x.to("meta"), torch.ones(8, device="meta"))
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype
    assert rn.launch_counts() == {"rms_norm": 0, "rms_norm_residual": 0}


# ---------------------------------------------------------------------------
# the CUDA kernels' host logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dtype,vectorized,want", [
    (128, torch.bfloat16, True, (8, 1, 16, 128)),     # serve q/k norms
    (128, torch.float32, True, (4, 1, 32, 128)),
    (2048, torch.bfloat16, True, (8, 1, 256, 256)),   # hidden rows
    (2560, torch.bfloat16, True, (8, 2, 256, 256)),
    (5120, torch.bfloat16, True, (8, 4, 256, 256)),
    (200, torch.bfloat16, True, (8, 1, 32, 128)),
    (200, torch.float32, False, (1, 1, 256, 256)),
    (1 << 16, torch.float32, False, (1, 64, 1024, 1024)),
    (1 << 16, torch.bfloat16, True, (8, 8, 1024, 1024)),
    (1, torch.float32, True, (1, 1, 1, 128)),
    (6, torch.bfloat16, True, (1, 1, 8, 128)),        # no whole vector
], ids=str)
def test_launch_geometry(d, dtype, vectorized, want):
    assert rn.launch_geometry(d, dtype, vectorized) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_launch_geometry_holds_every_width(dtype):
    """For every width up to MAX_D: whole vectors, a power-of-two team of
    at most 1024 lanes (a block of 128 threads holds whole teams of up to
    32, a wider team is its block), room for the row
    in the team's registers, no lane holding more than 64 floats, and at
    most a quarter of the slots empty beyond one vector a lane."""
    for d in list(range(1, 600)) + list(range(600, rn.MAX_D + 1, 97)) + \
            [rn.MAX_D]:
        for vectorized in (True, False):
            vec, vpt, team, threads = rn.launch_geometry(d, dtype,
                                                         vectorized)
            assert d % vec == 0 and vec in (1, 16 // torch.tensor(
                [], dtype=dtype).element_size())
            assert team & (team - 1) == 0 and 1 <= team <= 1024
            assert threads == (team if team > 32 else 128)
            assert team * vpt * vec >= d and vec * vpt <= 64
            if vpt > 1:
                assert team * (vpt // 2) * vec < d


def test_launch_args_pick_vectors_and_weight_reads():
    bf16 = torch.bfloat16
    x = torch.zeros(6, 128, dtype=bf16)
    w = torch.ones(128, dtype=bf16)
    out = torch.empty_like(x)
    args = rn.launch_args(x, w, out)
    assert args[:3] == (x.data_ptr(), w.data_ptr(), out.data_ptr())
    # rows, d, strides, dtype, weight kind, vec, vpt, team
    assert args[3:] == (6, 128, 128, 128, 1, 0, 8, 1, 16)
    # leading dims fold into rows
    assert rn.launch_args(x.view(2, 3, 1, 128), w, out)[3:] == args[3:]
    # a row stride of 129 elements is not 16-byte aligned: element loads
    strided = torch.zeros(6, 129, dtype=bf16)[:, :128]
    got = rn.launch_args(strided, w, out)
    assert got[0] == strided.data_ptr() and got[3:7] == (6, 128, 129, 128)
    assert got[-4:] == (0, 1, 1, 128)
    # weights of another dtype, or of x's dtype at an unaligned address,
    # are read element by element in their own dtype
    assert rn.launch_args(x, w.float(), out)[8] == 1
    assert rn.launch_args(x.float(), w, out.float())[8] == 2
    assert rn.launch_args(x, torch.ones(129, dtype=bf16)[1:], out)[8] == 2
    assert len(args) == rn._N_ARGS - 2      # the stream and eps come last
    with pytest.raises(TypeError, match="float32 or bfloat16 weight"):
        rn.launch_args(x, w.half(), out)


def _residual_case(case):
    """(x, residual, weight) of one residual_launch_args case."""
    bf16 = torch.bfloat16
    rows = lambda width=128, dtype=bf16: torch.zeros(6, width, dtype=dtype)
    w = torch.ones(128, dtype=bf16)
    if case == "contiguous":
        return rows(), rows(), w
    if case == "leading dims":
        return rows().view(2, 3, 128), rows().view(2, 3, 128), w
    if case == "x row stride 129":
        return rows(129)[:, :128], rows(), w
    if case == "residual row stride 136":        # 272 bytes: aligned
        return rows(), rows(136)[:, :128], w
    if case == "residual one element off":
        return rows(), torch.zeros(6 * 128 + 1, dtype=bf16)[1:].view(6, 128), w
    if case == "float32 weight":
        return rows(), rows(), w.float()
    assert case == "float32 rows"
    return rows(dtype=torch.float32), rows(dtype=torch.float32), w.float()


@pytest.mark.parametrize("case,strides,config", [
    # config: dtype, weight kind, vec, vpt, team
    ("contiguous", (128, 128), (1, 0, 8, 1, 16)),
    ("leading dims", (128, 128), (1, 0, 8, 1, 16)),
    ("x row stride 129", (129, 128), (1, 0, 1, 1, 128)),
    ("residual row stride 136", (128, 136), (1, 0, 8, 1, 16)),
    ("residual one element off", (128, 128), (1, 0, 1, 1, 128)),
    ("float32 weight", (128, 128), (1, 1, 8, 1, 16)),
    ("float32 rows", (128, 128), (0, 0, 4, 1, 32)),
])
def test_residual_launch_args(case, strides, config):
    """rms_norm_residual_launch's packed layout: the five pointers (the
    two outputs are the halves of one buffer), rows, width, the input
    row strides, then the config; vectors only where both inputs' rows
    are 16-byte aligned."""
    x, res, w = _residual_case(case)
    out = torch.empty(2 * x.numel(), dtype=x.dtype)
    args = rn.residual_launch_args(x, res, w, out)
    assert len(args) == rn._N_RESIDUAL_ARGS - 2   # the stream, eps last
    half = 6 * 128 * x.element_size()
    assert args[:5] == (x.data_ptr(), res.data_ptr(), w.data_ptr(),
                        out.data_ptr(), out.data_ptr() + half)
    assert args[5:9] == (6, 128) + strides
    assert args[9:] == config


@pytest.mark.parametrize("shape", [(6, 128), (2, 3, 128), (1, 1, 5),
                                   (0, 4), (4, 0, 3)], ids=str)
def test_contiguous_strides(shape):
    assert rn._contiguous(shape) == torch.empty(shape).stride()
