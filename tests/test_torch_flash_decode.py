"""The flash-decode kernel's plain version against the reference.

On the CPU :func:`repro_torch.kernels.ops.flash_decode` runs the plain
version (the CUDA kernels are held against it on the card by
``chip_smoke.py``; their launch geometry, packed arguments and accepted
shapes are checked here).  Two oracles from the JAX package:

* ``flash_decode_flat`` (the TPU kernel, in interpret mode, through
  ``repro.kernels.ops.flash_decode``) with a scalar length;
* ``models.attention._sdpa(q_offset=pos, kv_len=pos + 1)``, the function
  the reference's serve decode computes, with a per-row length.

Tolerances are the repo's kernel bars: float32 2e-5, bfloat16 2e-2.
"""

import re

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
@pytest.mark.parametrize("b,s,hq,hkv,d,kv_len", [
    (2, 40, 4, 2, 80, 33),        # zamba2's head dim
    (2, 24, 8, 2, 96, 24),
    (1, 40, 16, 1, 64, 29),       # group 16
    (2, 20, 32, 2, 80, 7)])       # both
def test_wide_groups_and_head_dims_match_the_tpu_kernel(dtype, b, s, hq,
                                                        hkv, d, kv_len):
    """The head dims and groups the kernel gained (D = 80, 96; group 16)
    against the TPU kernel in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(b, s, hq, hkv, d, seed=d * hq + kv_len)
    want = ref_ops.flash_decode(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                                kv_len)
    got = ops.flash_decode(_port(q, tdt), _port(k, tdt), _port(v, tdt),
                           kv_len)
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
    # meta tensors (the dry-run's) take the meta launch: an empty output
    # of the kernel's shape and dtype, nothing launched
    meta = [t.to("meta") for t in (q, k, v, lens)]
    out = fd.flash_decode(*meta)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert fd.launch_counts() == {"flash_decode": 0}


# ---------------------------------------------------------------------------
# the CUDA kernels' host logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_max,d,dtype,want", [
    (1, 128, torch.bfloat16, (128, 1, 64)),
    (40, 128, torch.bfloat16, (128, 1, 64)),
    (512, 128, torch.bfloat16, (128, 4, 64)),
    (513, 128, torch.bfloat16, (128, 5, 64)),
    (2048, 128, torch.bfloat16, (128, 16, 64)),    # the serve cache
    (32768, 128, torch.bfloat16, (512, 64, 64)),   # at most 64 chunks
    (2048, 128, torch.float32, (128, 16, 32)),     # 512-byte rows
    (2048, 256, torch.float32, (128, 16, 16)),
    (2048, 80, torch.bfloat16, (128, 16, 64)),
], ids=str)
def test_launch_geometry(s_max, d, dtype, want):
    assert fd.launch_geometry(s_max, d, dtype) == want


def test_launch_geometry_covers_every_cache_length():
    """Chunks of whole tiles that cover S_max with no empty last chunk,
    at most MAX_CHUNKS of them."""
    for s_max in list(range(0, 3000)) + list(range(3000, 1 << 20, 997)):
        for d, dtype in ((128, torch.bfloat16), (256, torch.float32),
                         (8, torch.float32)):
            chunk, n, tile = fd.launch_geometry(s_max, d, dtype)
            assert tile in (16, 32, 64) and chunk % 64 == 0
            assert chunk >= fd.MIN_CHUNK and 1 <= n <= fd.MAX_CHUNKS
            assert n * chunk >= s_max and (n - 1) * chunk < max(s_max, 1)
            row = d * (4 if dtype == torch.float32 else 2)
            assert 2 * tile * row <= 32768        # K and V of one stage


def test_launch_args_pack_pointers_geometry_and_strides():
    """flash_decode_launch's packed layout on a layer slice of a stacked
    cache (the decoder's layout) and a strided q."""
    b, s, hq, hkv, d = 3, 513, 8, 2, 64
    q = torch.zeros(b, hq, 2 * d, dtype=torch.bfloat16)[:, :, :d]
    k = torch.zeros(4, b, s, hkv, d, dtype=torch.bfloat16)[2]
    v = torch.zeros(4, b, s, hkv, d, dtype=torch.bfloat16)[1]
    kv_len = torch.tensor([1, 300, 513], dtype=torch.int32)
    args = fd.launch_args(q, k, v, kv_len, 1 << 20, 1 << 21)
    assert len(args) == fd._N_ARGS - 2      # the stream and scale last
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv_len.data_ptr(), 1 << 20, 1 << 21)
    assert args[6:12] == (b, hkv, hq // hkv, s, d, 1)
    assert args[12:15] == (128, 5, 64)
    assert args[15:] == (hq * 2 * d, 2 * d, s * hkv * d, hkv * d, d,
                         s * hkv * d, hkv * d, d)
    assert args[15:] == (*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])


@pytest.mark.parametrize("case", ["head dim stride 2", "row stride 4",
                                  "base one element off", "q head dim"])
def test_launch_args_refuse_what_the_kernel_cannot_copy(case):
    """Cache rows are copied in 16-byte pieces: a unit-stride head dim,
    16-byte aligned bases and strides, or a ValueError."""
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    lens = torch.ones(2, dtype=torch.int32)
    if case == "head dim stride 2":
        k = torch.zeros(2, 8, 2, 128, dtype=torch.bfloat16)[..., ::2]
    elif case == "row stride 4":       # 8 bytes: half a piece
        k = torch.zeros(2, 8, 2, 68, dtype=torch.bfloat16)[..., :64]
    elif case == "base one element off":
        k = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 8, 2, 64)
    else:
        q = torch.zeros(2, 4, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="unit-stride|16-byte"):
        fd.launch_args(q, k, k, lens, 0, 0)


def test_workspace_holds_every_chunks_partials():
    assert fd.workspace_floats(8, 16, 128, 1) == 0
    assert fd.workspace_floats(8, 16, 128, 8) == 8 * 16 * 8 * (128 + 2)


def test_kernel_shapes_are_the_ones_the_docstring_names():
    """The wrapper's shape check takes exactly what its docstring says:
    a head dim that is a multiple of 8 from 8 to 256, and Hq/Hkv from 1
    to 16.  Held through the wrapper itself on the meta device, where an
    accepted shape gets as far as the meta launch (the dry-run's)."""
    doc = " ".join(fd.flash_decode.__doc__.split())
    assert "a multiple of 8 from 8 to 256 and Hq/Hkv from 1 to 16" in doc
    assert (fd.HEAD_DIM_STEP, fd.MAX_HEAD_DIM, fd.MAX_GROUP) == (8, 256, 16)
    meta = dict(device="meta", dtype=torch.bfloat16)
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    shapes = [(d, g) for d in range(1, 265) for g in (1, 2, 16, 17)] + \
        [(d, g) for d in (8, 80, 256) for g in range(1, 21)]
    for d, group in shapes:
        q = torch.empty(1, group, d, **meta)
        k = torch.empty(1, 4, 1, d, **meta)
        accepted = d % 8 == 0 and 8 <= d <= 256 and 1 <= group <= 16
        if accepted:
            out = fd.flash_decode(q, k, k, lens)
            assert out.is_meta and out.shape == q.shape, (d, group)
            continue
        with pytest.raises(ValueError) as err:
            fd.flash_decode(q, k, k, lens)
        assert re.search(r"head dim|Hq/Hkv", str(err.value)), \
            (d, group, str(err.value))


def test_row_lengths_pass_a_ready_tensor_through():
    """The decode step's (B,) int32 lengths reach the kernel as they
    are; anything else is converted to one."""
    q = torch.zeros(3, 4, 8)
    lens = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert ops._row_lengths(lens, q) is lens
    for other in (lens.long(), 5, torch.tensor(5), lens.repeat(2)[::2]):
        got = ops._row_lengths(other, q)
        assert got is not other and got.dtype == torch.int32
        assert got.shape == (3,) and got.is_contiguous()
