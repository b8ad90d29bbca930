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

Tolerances are the repo's kernel bars: float32 2e-5, bfloat16 2e-2.  A
numerics model of the bfloat16 tensor-core kernel (its tiles, exp2 and
rounding of P) is held to the same oracles at the bfloat16 bar, and the
wrapper's host logic (dtype dispatch, launch geometry, alignment checks)
is checked against a stand-in for the CUDA library.
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [80, 96])
def test_new_head_dims_match_the_reference(d, dtype, causal):
    """Head dims the kernels now take (zamba2-2.7b's 80, and 96): the
    plain version against the TPU kernel in interpret mode and against
    the jnp oracle, at the kernel bars."""
    b, s, hq, hkv = 1, 128, 4, 2
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, s, hq, hkv, d, seed=d),
                                       dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    tol = DTYPES[dtype][2]
    _close(got, ref_ops.flash_attention(jq, jk, jv, causal=causal), tol)
    flat = [x.transpose(0, 2, 1, 3).reshape(-1, s, d) for x in (jq, jk, jv)]
    want = ref_kernels.flash_attention_ref(*flat, group=hq // hkv,
                                           causal=causal)
    _close(got, want.reshape(b, hq, s, d).transpose(0, 2, 1, 3), tol)


def test_head_dim_rule_takes_zamba2():
    """The kernels' head-dim rule, read as the CPU sees it: every multiple
    of 8 from 8 to 128, zamba2-2.7b's 80 and qwen3-1.7b's 128 among them;
    other widths raise naming the rule before any launch."""
    from repro.configs import qwen3_1_7b, zamba2_2_7b
    for cfg in (zamba2_2_7b.build(), qwen3_1_7b.build()):
        assert fa.head_dim_ok(cfg.head_dim)
    assert [d for d in range(257) if fa.head_dim_ok(d)] == \
        list(range(8, 129, 8))
    assert "multiple of 8" in fa.HEAD_DIM_RULE
    q = torch.zeros(1, 8, 2, 100)
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
        fa._launch(q, q, q, causal=True)


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
    # meta tensors (the dry-run's) take the meta launch: an empty output
    # of the kernel's shape and dtype, nothing launched
    before = fa.LAUNCHES
    out = fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert fa.LAUNCHES == before
    ops.flash_attention(q, k, k)
    assert fa.LAUNCHES == before       # the plain version counts nothing
    assert "flash_attention" in ops.launch_counts()


# ---------------------------------------------------------------------------
# the bfloat16 tensor-core kernel: its numerics and its host logic
# ---------------------------------------------------------------------------

KEYS = 64                      # the bf16 kernel's key tile
LOG2E = 1.4426950408889634


def _tensor_core_model(q, k, v, causal):
    """What the bf16 kernel computes, tile by tile, in float32 on the CPU:
    rows flattened position-major per kv head, an online softmax over
    tiles of 64 keys with the scale log2(e)/sqrt(D) on the f32 scores and
    exp2, masked scores at -1e30, P rounded to bf16 before P V, the
    max(l, 1e-30) floor, the result rounded to q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, s * g, d)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    c = LOG2E / np.sqrt(d)
    qpos = torch.arange(s * g) // g
    m = torch.full((b, hkv, s * g), -1e30)
    l = torch.zeros(b, hkv, s * g)
    o = torch.zeros(b, hkv, s * g, d)
    for k0 in range(0, s, KEYS):
        kt, vt = kf[:, :, k0:k0 + KEYS], vf[:, :, k0:k0 + KEYS]
        sc = qf @ kt.transpose(-1, -2)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])
            sc = torch.where(keys[None, :] > qpos[:, None], -1e30, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(sc * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ vt
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hkv, s, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, s, hq, d).to(q.dtype)


@pytest.mark.parametrize("s", [1024, 1000])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_fit_the_bf16_bar(causal, group, d, s):
    """The bf16 kernel's roundings (P to bf16 before P V, exp2 of scaled
    f32 scores, 64-key tiles) against the jnp oracle and, causal, the TPU
    kernel in interpret mode: within the bf16 bar of 2e-2."""
    hkv = 2
    arrays = _inputs(1, s, hkv * group, hkv, d, seed=s + 10 * group + d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bfloat16")
    got = _tensor_core_model(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16
    flat = [x.transpose(0, 2, 1, 3).reshape(-1, s, d) for x in (jq, jk, jv)]
    want = ref_kernels.flash_attention_ref(*flat, group=group, causal=causal)
    _close(got, want.reshape(1, hkv * group, s, d).transpose(0, 2, 1, 3),
           2e-2)
    if causal:
        _close(got, ref_ops.flash_attention(jq, jk, jv, causal=True), 2e-2)


class _FakeLib:
    """Records the C entry point's arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def flash_attention_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    monkeypatch.setattr(fa, "_stream", lambda dev: 0)
    # the CPU tensors' device (index None) is the current one, so the
    # device guard calls the library directly
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    return lib


def test_dtype_picks_the_kernel(fake_lib):
    """float32 goes to the CUDA-core kernel (code 0), bfloat16 to the
    tensor-core kernel (code 1); both count in the one LAUNCHES."""
    assert fa.KERNEL_OF == {torch.float32: "flash_attention_kernel_f32",
                            torch.bfloat16: "flash_attention_kernel_bf16"}
    before = fa.LAUNCHES
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q = torch.zeros(2, 40, 6, 64, dtype=dtype)
        k = torch.zeros(2, 40, 2, 64, dtype=dtype)
        out = fa._launch(q, k, k, causal=True)
        assert out.shape == q.shape and out.dtype == dtype
        assert fake_lib.calls[-1][4:11] == (2, 40, 2, 3, 64, 1, code)
    assert fa.LAUNCHES == before + 2


@pytest.mark.parametrize("b,s,hkv,group", [
    (2, 2048, 8, 2), (1, 1000, 8, 2), (1, 384, 1, 8), (2, 128, 2, 3),
    (2, 200, 2, 2), (3, 1, 1, 1)])
def test_launch_geometry_covers_every_tile_heaviest_first(b, s, hkv, group):
    n_f32 = -(-s * group // 64)
    assert fa.launch_geometry(b, s, hkv, group, torch.float32) == \
        (n_f32, hkv, b)
    n_qt = -(-s * group // 128)
    blocks, y, z = fa.launch_geometry(b, s, hkv, group, torch.bfloat16)
    assert (blocks, y, z) == (n_qt * hkv * b, 1, 1)
    tiles = [fa.block_tile(i, b, s, hkv, group) for i in range(blocks)]
    assert sorted(tiles) == [(t, h, r) for t in range(n_qt)
                             for h in range(hkv) for r in range(b)]
    first_tiles = [t for t, _, _ in tiles]
    assert first_tiles == sorted(first_tiles, reverse=True)
    # the first hkv * b blocks are every (head, row)'s last query tile
    assert set(tiles[:hkv * b]) == {(n_qt - 1, h, r) for h in range(hkv)
                                    for r in range(b)}


def test_bf16_kernel_refuses_misaligned_inputs(fake_lib):
    """16-byte copies and TMA maps: a bf16 operand at a base off 16
    bytes, with a stride that is no multiple of 8 elements or a zero
    (broadcast) stride is no longer refused: the kernel is given a fresh
    contiguous copy of it (counted in ALIGN_COPIES, its values equal),
    and the operands already laid out so go as they are; float32 takes
    every layout as it is; a stride of a dim of length 1 does not
    matter."""
    bf16 = torch.bfloat16
    k = torch.zeros(1, 16, 1, 64, dtype=bf16)
    odd_stride = torch.randn(1, 16, 3, 65).to(bf16)[..., :64]
    off_base = torch.randn(16 * 3 * 64 + 4).to(bf16)[4:].view(1, 16, 3, 64)
    broadcast = torch.zeros(1, 1, 1, 64, dtype=bf16).expand(1, 16, 1, 64)
    before, copies = fa.LAUNCHES, fa.ALIGN_COPIES
    for q in (odd_stride, off_base):
        assert not fa.tma_layout_ok(q)
        fa._launch(q, k, k, causal=True)
        ptr = fake_lib.calls[-1][0]
        assert ptr != q.data_ptr() and ptr % 16 == 0
    fa._launch(torch.zeros(1, 16, 3, 64, dtype=bf16), off_base[:, :, :1],
               k, causal=False)
    fa._launch(torch.zeros(1, 16, 2, 64, dtype=bf16), broadcast, k,
               causal=True)
    assert fake_lib.calls[-1][1] != broadcast.data_ptr()
    assert fake_lib.calls[-1][2] == k.data_ptr()      # aligned: as it is
    assert fa.ALIGN_COPIES == copies + 4
    assert fa.LAUNCHES == before + 4
    odd_f32 = torch.zeros(1, 16, 3, 65)[..., :64]
    fa._launch(odd_f32, k.float(), k.float(), causal=True)
    assert fake_lib.calls[-1][0] == odd_f32.data_ptr()
    fa._launch(torch.zeros(16 * 3 * 64 + 1)[1:].view(1, 16, 3, 64),
               k.float(), k.float(), causal=True)
    single = torch.zeros(16 * 3 * 64, dtype=bf16).as_strided(
        (1, 16, 3, 64), (7, 192, 64, 1))
    fa._launch(single, k, k, causal=True)
    assert fake_lib.calls[-1][0] == single.data_ptr()
    assert fa.ALIGN_COPIES == copies + 4
    assert fa.LAUNCHES == before + 7


def test_misaligned_copy_keeps_the_values():
    """The copy the bf16 path takes is the operand's values in a layout
    the kernel reads: the plain version gives the same result on it."""
    rng = np.random.default_rng(43)
    base = torch.from_numpy(rng.normal(size=16 * 3 * 64 + 4).astype(
        np.float32)).bfloat16()
    q = base[4:].view(1, 16, 3, 64)
    kv = torch.from_numpy(rng.normal(size=(1, 16, 1, 65)).astype(
        np.float32)).bfloat16()[..., :64]
    before = fa.ALIGN_COPIES
    q2, k2 = fa._aligned(q), fa._aligned(kv)
    assert fa.ALIGN_COPIES == before + 2
    assert fa.tma_layout_ok(q2) and fa.tma_layout_ok(k2)
    assert torch.equal(fa.flash_attention_plain(q2, k2, k2),
                       fa.flash_attention_plain(q, kv, kv))
