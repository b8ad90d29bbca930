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


@pytest.mark.parametrize("n", [2048, 3000, 4096 * 3, 4097, 40_000, 100_003])
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
    # meta tensors (the dry-run's) take the meta launch: empty outputs of
    # the kernel's shapes and dtypes, nothing launched
    before = ops.launch_counts()
    mq, ms = qz.quantize(x.to("meta"), 1024)
    assert mq.is_meta and mq.shape == q.shape and mq.dtype == torch.int8
    assert ms.is_meta and ms.shape == s.shape and ms.dtype == torch.float32
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# the kernel's launch geometry (kernels/quantize.py launch_geometry), and
# the two passes of csrc/quantize.cu replayed on it step by step
# ---------------------------------------------------------------------------

# (n, block, resident CTAs): the main path's shard (qwen3-1.7b, W = 2), a
# block of 100,003 (no multiple of 4 or 8), fewer tiles than CTAs, a block
# just over one tile, one CTA for everything, and fused blocks (one tile
# each, blocks the 16-byte chunks straddle, tiny blocks)
GEOMETRIES = [(2 * 176_218_112, 176_218_112, 528),
              (3 * 100_003, 100_003, 528), (2 * 40_000, 40_000, 528),
              (5 * 4099, 4099, 528), (5 * 4099, 4099, 1),
              (3 * 100_003, 100_003, 7), (4096, 4096, 528),
              (3 * 4095, 4095, 528), (3 * 2050, 2050, 528), (7 * 5, 5, 528)]
SIMULATED = [g for g in GEOMETRIES if g[0] < 1 << 20]


@pytest.mark.parametrize("n,block,max_grid", GEOMETRIES)
def test_launch_geometry_covers_every_element_once(n, block, max_grid):
    geo = qz.launch_geometry(n, block, max_grid)
    assert geo.fused == (block <= qz.TILE)
    if geo.fused:
        # a CTA of THREADS a block; thread t takes the groups (aligned to
        # the input) t, t + THREADS, ...; each thread gets a whole group
        # and divides at most twice block / THREADS elements, plus the
        # group the block starts inside
        g = geo.group
        assert geo.grid == n // block and geo.partials == 1
        assert g in (2, 4, 8, 16) and (g == 2 or g * qz.THREADS <= block)
        covered = np.zeros(n, np.int32)
        for b in range(geo.blocks):
            start, end = b * block, (b + 1) * block
            groups = range(start // g * g, end, g)
            for g0 in groups:
                covered[max(g0, start):min(g0 + g, end)] += 1
            per_thread = -(-len(groups) // qz.THREADS) * g
            assert per_thread <= max(2 * block // qz.THREADS, 2) + g
        assert (covered == 1).all()
        return
    assert 1 <= geo.grid <= max_grid and geo.span % qz.TILE == 0
    tiles = [t for c in range(geo.grid) for t in geo.tiles(c)]
    assert all(geo.span_of(c)[0] < geo.span_of(c)[1]
               for c in range(geo.grid))          # no CTA idles
    assert tiles[0][0] == 0 and tiles[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(ts % qz.TILE == 0 and 0 < te - ts <= qz.TILE
               for ts, te in tiles)
    if max_grid >= -(-n // qz.TILE):
        assert geo.span == qz.TILE                # a tile a CTA


@pytest.mark.parametrize("n,block,max_grid",
                         [g for g in GEOMETRIES if g[1] > qz.TILE])
def test_partials_are_one_slot_per_cta_and_block(n, block, max_grid):
    """Pass 1 writes slot c + b for every block b CTA c's span meets;
    the slots are distinct and fit the workspace, and pass 2 reads for
    block b exactly the slots of the CTAs that wrote one for it."""
    geo = qz.launch_geometry(n, block, max_grid)
    pieces = [(c, b) for c in range(geo.grid) for b in geo.blocks_of(c)]
    slots = [geo.slot(c, b) for c, b in pieces]
    assert len(set(slots)) == len(slots)
    assert max(slots) < geo.partials == geo.grid + geo.blocks - 1
    for b in range(geo.blocks):
        assert list(geo.ctas_of(b)) == [c for c, bb in pieces if bb == b]
    for c in (0, geo.grid // 2, geo.grid - 1):
        assert list(geo.tiles(c, reverse=True)) == \
            list(geo.tiles(c))[::-1]


def _simulate(x: torch.Tensor, block: int, max_grid: int):
    """The persistent passes of ``csrc/quantize.cu`` replayed on the CPU,
    tile by tile and CTA by CTA as the kernels walk them: pass 1 writes
    each piece's absmax to its slot (the workspace starts as NaN, so a
    slot read before it is written shows), pass 2 walks each span's
    tiles in reverse, reduces the block's slots when it enters a block,
    and quantizes; the scale of a block is written by the CTA holding its
    first element."""
    n = x.numel()
    geo = qz.launch_geometry(n, block, max_grid)
    xf = x.float()
    partials = torch.full((geo.partials,), float("nan"))
    for c in range(geo.grid):
        lo, hi = geo.span_of(c)
        b = lo // block
        bend = (b + 1) * block
        m = torch.tensor(0.0)
        for ts, te in geo.tiles(c):
            a = xf[ts:te].abs()
            if te <= bend:
                m = torch.maximum(m, a.max())
            else:
                cut = max(bend - ts, 0)
                if cut:
                    m = torch.maximum(m, a[:cut].max())
                partials[geo.slot(c, b)] = m
                m = a[cut:].max()
                b, bend = b + 1, bend + block
        partials[geo.slot(c, b)] = m
    q = torch.zeros(n, dtype=torch.int8)
    scales = torch.full((geo.blocks,), float("nan"))

    def block_scale(b, c):
        got = partials[[geo.slot(cc, b) for cc in geo.ctas_of(b)]]
        assert not got.isnan().any()
        absmax = torch.clamp(got.max(), min=1e-12)
        scale = absmax / torch.full_like(absmax, 127.0)
        if c == geo.ctas_of(b)[0]:
            scales[b] = scale
        return scale

    for c in range(geo.grid):
        lo, hi = geo.span_of(c)
        b = (hi - 1) // block
        bstart = b * block
        scale = block_scale(b, c)
        for ts, te in geo.tiles(c, reverse=True):
            per = torch.full((te - ts,), float(scale))
            if ts < bstart:
                prev = block_scale(b - 1, c)
                per[:bstart - ts] = prev
                b, bstart, scale = b - 1, bstart - block, prev
            q[ts:te] = torch.clamp(torch.round(xf[ts:te] / per), -127,
                                   127).to(torch.int8)
    return q, scales


@pytest.mark.parametrize("n,block,max_grid",
                         [g for g in SIMULATED if g[1] > qz.TILE])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_kernels_two_passes_give_the_plain_bits(n, block, max_grid,
                                                    dtype):
    """Replayed on the geometry, the kernel's passes give q and the
    scales of the plain version bit for bit, with one block's values
    much larger than the others' (so a wrong slot shows) and a large
    value and a small one on the two sides of each block boundary (so an
    element given its neighbour block's scale shows)."""
    x = _input(n, seed=n + max_grid)
    x[block: 2 * block] *= 50.0
    for b in range(1, n // block):
        x[b * block - 1: b * block + 1] = [63.5, -0.5]
    _, xt = _both(x, dtype)
    q, s = _simulate(xt, block, max_grid)
    q_p, s_p = qz.quantize_plain(xt, block)
    assert torch.equal(s, s_p)
    assert torch.equal(q, q_p)

