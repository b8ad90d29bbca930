"""Quick check of the CUDA kernels of the serve, forward and training
paths on one card.

    PYTHONPATH=src python -m repro_torch.kernels.selfcheck [SECTION ...]

Sections (all by default):

* ``decode`` — compiles ``csrc/flash_decode.cu`` and ``csrc/rmsnorm.cu``
  with ``nvcc -Xptxas -v`` and prints the registers and spills of
  ``flash_decode_split_kernel``, ``flash_decode_merge_kernel`` and
  ``rms_norm_residual_kernel``; then holds flash decode against its plain
  version at the serve shape (B=8 Hq=16 Hkv=8 D=128 S_max=2048) with the
  serve run's lengths, mixed lengths and all lengths 2048, at D = 80,
  D = 256 and group 16, and on caches of one and two chunks; and
  ``rms_norm_residual`` at the serve and forward paths' rows and at
  strided and misaligned rows, in float32 and bfloat16, with the time of
  SDPA's call beside each flash-decode case;
* ``forward`` — compiles ``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu``
  and ``csrc/rmsnorm.cu`` with ``nvcc -Xptxas -v`` and prints each
  kernel's registers and spills (the attention kernels at D = 80, 96 and
  128) and the count of tensor-core instructions in its machine code
  (``HGMMA`` for the attention kernels, ``HMMA`` for the four SSD
  kernels); checks one tile of the bfloat16 attention kernel's
  tensor-core steps (``q k^T`` and ``bf16(q k^T) v`` through the
  ``wgmma`` operand layouts) against plain products at D = 32, 40, 64,
  80, 96 and 128; checks each of the SSD scan's four steps (the scores,
  the prefix sums, the chunks' own states, the states passed between
  chunks) against plain products; then holds flash attention, the SSD
  scan and ``rms_norm`` against their plain versions at the forward and
  serve paths' shapes, zamba2's and the ``tests/test_kernels.py`` shapes,
  in float32 and bfloat16, with the time of one library call beside each
  attention and ``rms_norm`` case, and the profiler's device time of
  each of the SSD scan's four kernels at mamba2-2.7b's and zamba2-2.7b's
  shapes;
* ``quantize`` — compiles ``csrc/quantize.cu`` with ``-Xptxas -v`` and
  prints each kernel's registers, spills and shared memory, and the CTAs
  of the cooperative kernel resident an SM (the occupancy API's figure;
  achieved occupancy needs a profiler this machine may lack); then
  quantize and dequantize must equal their plain versions bit for bit
  (the ``tests/test_quantize_kernel.py`` shapes, 2**24 elements, one
  block of 2**26, a block of 100,003 (no multiple of 4 or 8) f32 and
  bf16, fewer tiles than CTAs, a block just over one tile, an input that
  is not 16-byte aligned, zeros and exact .5 ties); and at the train
  path's largest bucket shard (qwen3-1.7b at W = 2: 2 x 176,218,112
  float32) the profiler's device time of each kernel of a call and the
  device operations a call;
* ``grad`` — the gradient through each forward kernel site (RMSNorm,
  fused residual RMSNorm, flash attention, SSD scan) against plain
  autograd of its plain version, float32;
* ``smc`` — compiles ``csrc/smc_sweep.cu`` with ``-Xptxas -v``, then
  holds the watermark kernel (its closed form) against the plain twin
  and :func:`smc_sweep_watermark_closed_form`, exactly, at the multicast
  path's lane counts, at 2**20 lanes and at lanes near INT32_MAX /
  INT32_MIN, masked and not, with its CUDA-event time and the time of
  the three-op PyTorch closed form beside each; and the ring kernel
  against its plain twin and the watermark sweep at the same lanes,
  with its profiler device time.

It prints the largest error and the CUDA-event time of each case and
fails on a compile error or an error above the bars.  Meant as the
first, short call after a kernel changes, before a full
``chip_smoke.py`` run.  Needs a CUDA GPU and ``nvcc``; exits 2 without a
GPU.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import smc_sweep as ss
from repro_torch.kernels import ssd_scan as sc

ATTENTION_SHAPES = ((2, 2048, 16, 8, 128), (1, 1000, 16, 8, 128),
                    (1, 384, 8, 1, 128), (2, 128, 6, 2, 32),
                    (2, 200, 4, 2, 64), (4, 512, 16, 8, 128),
                    (1, 2048, 32, 32, 80), (2, 300, 8, 2, 96),
                    (1, 200, 4, 2, 40))
# (B, S, H, P, N, G, chunk): mamba2-2.7b's scan, zamba2-2.7b's (P, N),
# the widest shape the kernels take, a ragged chunk and P = 48, and the
# tests/test_kernels.py shapes
SSD_SHAPES = ((1, 2048, 80, 64, 128, 1, 256), (1, 2048, 80, 64, 64, 1, 256),
              (1, 512, 8, 128, 256, 2, 64), (1, 300, 4, 48, 32, 2, 100),
              (1, 64, 2, 16, 16, 1, 16), (2, 128, 4, 32, 64, 2, 32),
              (1, 96, 2, 64, 128, 1, 32))
TILE_HEAD_DIMS = (32, 40, 64, 80, 96, 128)
QUANTIZE_SHAPES = ((2048, 2048), (8192, 2048), (4096, 512), (1 << 24, 2048),
                   (1 << 26, 1 << 26), (3 * 5000, 5000),
                   (3 * 100_003, 100_003), (2 * 40_000, 40_000),
                   (5 * 4099, 4099))
# qwen3-1.7b's largest bucket shard at W = 2 (chip_smoke.py train_plan)
QUANTIZE_MAIN = (2 * 176_218_112, 176_218_112)
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# (rows, width, how the rows are laid out): the serve and forward paths'
# norms, and rows the kernel must read element by element
RMS_SHAPES = ((128, 128, "contiguous"), (8, 2048, "contiguous"),
              (2048, 2560, "contiguous"), (2048, 5120, "contiguous"),
              (65536, 128, "contiguous"), (5, 200, "contiguous"),
              (64, 1024, "row stride 1025"), (1, 1 << 16, "contiguous"))
# (label, B, Hq, Hkv, D, S_max, lengths): the serve plane's shape with the
# serve run's lengths (prompts of 8-24 tokens plus up to 16 generated),
# mixed and full lengths, and the head dims and groups the kernel takes
DECODE_CASES = (
    ("serve", 8, 16, 8, 128, 2048, [9, 40, 17, 24, 31, 12, 38, 26]),
    ("mixed", 8, 16, 8, 128, 2048, [1, 511, 512, 513, 2048, 37, 1024, 1500]),
    ("all 2048", 8, 16, 8, 128, 2048, [2048] * 8),
    ("D=80", 4, 32, 8, 80, 1024, [1024, 700, 3, 1]),
    ("D=256", 2, 8, 2, 256, 600, [600, 257]),
    ("group 16", 4, 16, 1, 128, 2048, [2048, 1000, 1, 513]),
    ("one chunk", 3, 12, 4, 64, 100, [100, 64, 1]),
    ("two chunks", 3, 12, 4, 64, 200, [200, 64, 129]))
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (rows, width, layout) of the residual norm: the serve plane's hidden
# rows, the forward's, and rows it must read element by element
RESIDUAL_SHAPES = ((8, 2048, "contiguous"), (4096, 2048, "contiguous"),
                   (2048, 2560, "contiguous"), (5, 200, "contiguous"),
                   (64, 1024, "row stride 1025"),
                   (64, 1024, "residual one element off"))
# q k^T and bf16(q k^T) v of one tile: bf16 products are exact in float32,
# so only the order of the f32 sums differs
TILE_TOL = 1e-4


def event_ms(fn, iters: int = 5) -> float:
    """Mean CUDA-event time of ``fn()`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(got, want, tol: float) -> float:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
        raise AssertionError(f"max error {err} beyond {tol}")
    return err


def compile_report(name: str, keep=(), opcode: str = "HGMMA") -> None:
    """nvcc's -Xptxas -v lines (registers, spills) for ``csrc/<name>.cu``
    (of the kernels whose names hold one of ``keep``, where given) and,
    where the toolkit has ``cuobjdump``, the count of ``opcode``
    instructions (HGMMA: ``wgmma``; HMMA: ``mma.sync``) in each kernel's
    machine code."""
    with tempfile.TemporaryDirectory() as tmp:
        lib = f"{tmp}/{name}.so"
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             lib, str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        shown = True
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling" in line:
                shown = not keep or any(k in line for k in keep)
            if shown and ("registers" in line or "spill" in line
                          or "Compiling" in line):
                print(f"{name}: {line.strip()}")
        cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
        if cuobjdump.exists():
            sass = subprocess.run([str(cuobjdump), "-sass", lib],
                                  capture_output=True, text=True).stdout
            for fn, count in sass_opcode_counts(sass, opcode).items():
                if not keep or any(k in fn for k in keep):
                    print(f"{name}: {fn}: {count} {opcode} instructions")


def sass_opcode_counts(sass: str, opcode: str) -> dict:
    """Per function of a ``cuobjdump -sass`` listing, the count of
    instructions with ``opcode``; functions without one are left out."""
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
        elif fn and (f" {opcode}." in line or f" {opcode} " in line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def check_tiles(gen) -> None:
    """The bf16 kernel's two tensor-core steps on one tile, alone."""
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for d in TILE_HEAD_DIMS:
        q = rnd(128, d).bfloat16()
        k, v = rnd(64, d).bfloat16(), rnd(64, d).bfloat16()
        s, o = fa.tile_check(q, k, v)
        s_err = close(s, q.float() @ k.float().T, TILE_TOL)
        o_err = close(o, s.bfloat16().float() @ v.float(), TILE_TOL)
        print(f"flash_attention tile D={d}: q k^T err {s_err:.3g}, "
              f"P v err {o_err:.3g}", flush=True)


def sdpa(q, k, v, causal):
    """One ``scaled_dot_product_attention`` call on the same inputs (a
    yardstick; the port never calls it)."""
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    return torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True)


def rms_rows(gen, rows: int, d: int, layout: str, dtype):
    x = torch.randn(rows, d + (layout != "contiguous"), generator=gen,
                    device="cuda").to(dtype)[:, :d]
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    return x, w


def check_rms_norm(gen) -> None:
    F = torch.nn.functional
    for rows, d, layout in RMS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_rows(gen, rows, d, layout, dtype)
            err = close(rn.rms_norm(x, w), rn.rms_norm_plain(x, w),
                        ATTENTION_TOL[dtype])
            ms = event_ms(lambda: rn.rms_norm(x, w), 50)
            lib_ms = event_ms(lambda: F.rms_norm(x, (d,), w, 1e-6), 50)
            print(f"rms_norm {rows}x{d} {layout} {dtype}: err {err:.3g}, "
                  f"{ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms", flush=True)


def sdpa_decode(q, k, v, kv_len):
    """One ``scaled_dot_product_attention`` call over the same decode
    inputs, with a boolean mask (a yardstick; the port never calls it)."""
    s = k.shape[1]
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def check_decode(gen) -> None:
    compile_report("flash_decode", ("flash_decode_split_kernel",
                                    "flash_decode_merge_kernel"))
    compile_report("rmsnorm", ("rms_norm_residual_kernel",))
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for label, b, hq, hkv, d, s_max, lens in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(b, hq, d).to(dtype)
            k, v = (rnd(b, s_max, hkv, d).to(dtype) for _ in range(2))
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            err = close(fd.flash_decode(q, k, v, kv_len),
                        fd.flash_decode_plain(q, k, v, kv_len),
                        DECODE_TOL[dtype])
            ms = event_ms(lambda: fd.flash_decode(q, k, v, kv_len), 50)
            lib_ms = event_ms(lambda: sdpa_decode(q, k, v, kv_len), 50)
            chunk, n, tile = fd.launch_geometry(s_max, d, dtype)
            print(f"flash_decode {label} B={b} Hq={hq} Hkv={hkv} D={d} "
                  f"S_max={s_max} {dtype} ({n} chunks of {chunk}, tiles "
                  f"of {tile}): err {err:.3g}, {ms:.4f} ms, SDPA "
                  f"{lib_ms:.4f} ms", flush=True)
    for rows, d, layout in RESIDUAL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_rows(gen, rows, d, "contiguous"
                            if layout.startswith("residual") else layout,
                            dtype)
            res = rnd(rows * d + 1).to(dtype)[1:].view(rows, d) \
                if layout.startswith("residual") else rnd(rows, d).to(dtype)
            got = rn.rms_norm_residual(x, res, w)
            want = rn.rms_norm_residual_plain(x, res, w)
            err = max(close(g, w_, ATTENTION_TOL[dtype])
                      for g, w_ in zip(got, want))
            ms = event_ms(lambda: rn.rms_norm_residual(x, res, w), 50)
            print(f"rms_norm_residual {rows}x{d} {layout} {dtype}: err "
                  f"{err:.3g}, {ms:.4f} ms", flush=True)


def check_ssd_steps(gen) -> None:
    """Each step of the SSD kernels against plain products computed from
    the same inputs (and, from step (ii) on, from the kernels' own prefix
    sums), at mamba2's shape, a ragged chunk with P = 48 and the widest
    shape, both dtypes."""
    for b, s, h, p, n, g, chunk in (SSD_SHAPES[0], SSD_SHAPES[3],
                                     SSD_SHAPES[2]):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a_log, bb, cc, d_skip, dt_bias = ssd_args(
                gen, b, s, h, p, n, g, dtype)
            ws = sc.stage_check(x, dt, a_log, bb, cc, d_skip, dt_bias, chunk)
            torch.cuda.synchronize()
            nc, rep = s // chunk, h // g
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            cf = cc.float().view(b, nc, chunk, g, n)
            bf = bb.float().view(b, nc, chunk, g, n)
            want = torch.einsum("bclgn,bcsgn->bcgls", cf, bf)
            tri = torch.ones(chunk, chunk, device="cuda").tril().bool()
            got = ws["scores"][..., :chunk, :chunk]
            errs = {"scores": close(torch.where(tri, got.float(), 0),
                                    torch.where(tri, want, 0),
                                    1e-4 if dtype == torch.float32
                                    else 1e-2)}
            dts = torch.nn.functional.softplus(dt.float() + dt_bias)
            da = (dts * -torch.exp(a_log)).view(b, nc, chunk, h)
            # as the plain version scans: over the last dim of (B, H, nc, L)
            cs = torch.cumsum(da.permute(0, 3, 1, 2), -1).reshape(b, h, s)
            errs["dts"] = close(ws["dts"], dts.permute(0, 2, 1), 1e-5)
            errs["cs"] = close(ws["cs"], cs, 1e-4)
            kcs = ws["cs"].view(b, h, nc, chunk)
            w = ws["dts"].view(b, h, nc, chunk) * torch.exp(
                kcs[..., -1:] - kcs)
            errs["w"] = close(ws["w"], w.reshape(b, h, s), 1e-5)
            xw = x.float().view(b, nc, chunk, h, p) * \
                w.permute(0, 2, 3, 1)[..., None]
            bh = bf.repeat_interleave(rep, dim=3)
            local = torch.einsum("bclhp,bclhn->bchpn", xw, bh)
            errs["local"] = close(ws["local"], local, tol)
            st, s_in = torch.zeros_like(local[:, 0]), []
            for ci in range(nc):
                s_in.append(st)
                st = torch.exp(kcs[:, :, ci, -1])[..., None, None] * st + \
                    ws["local"][:, ci]
            errs["s_in"] = close(ws["s_in"].float(), torch.stack(s_in, 1),
                                 tol)
            errs["state"] = close(ws["state"], st, 1e-3)
            y_want, _ = sc.ssd_scan_plain(x, dt, a_log, bb, cc, d_skip,
                                          dt_bias, chunk)
            errs["y"] = close(ws["y"], y_want, SSD_TOL[dtype])
            print(f"ssd_scan steps B={b} S={s} H={h} P={p} N={n} G={g} "
                  f"chunk={chunk} {dtype}: " + ", ".join(
                      f"{k} {v:.3g}" for k, v in errs.items()), flush=True)


def profile_ssd(gen) -> None:
    """Device time a call of each of the SSD scan's kernels, from the
    profiler over 20 warm calls, at mamba2-2.7b's and zamba2-2.7b's scan
    shapes, dt in x's dtype as the model slices it."""
    from torch.profiler import ProfilerActivity, profile
    for b, s, h, p, n, g, chunk in SSD_SHAPES[:2]:
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, *rest = ssd_args(gen, b, s, h, p, n, g, dtype)
            args = (x, dt.to(dtype), *rest, chunk)
            for _ in range(3):
                sc.ssd_scan(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    sc.ssd_scan(*args)
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                name = re.search(r"ssd_scan_[a-z]+_kernel", e.key)
                if name:
                    times[name.group()] = times.get(name.group(), 0.0) + \
                        getattr(e, "self_device_time_total", 0) / 20
            print(f"ssd_scan profile B={b} S={s} H={h} P={p} N={n} "
                  f"chunk={chunk} {dtype}: " + ", ".join(
                      f"{k} {v:.2f} us" for k, v in times.items())
                  + f", total {sum(times.values()):.2f} us", flush=True)


def check_forward(gen) -> None:
    compile_report("flash_attention", ("Li80E", "Li96E", "Li128E"))
    compile_report("ssd_scan", opcode="HMMA")
    compile_report("rmsnorm")
    check_tiles(gen)
    check_ssd_steps(gen)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for b, s, hq, hkv, d in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rnd(b, s, h, d).to(dtype) for h in (hq, hkv, hkv))
            for causal in (True, False):
                err = close(fa.flash_attention(q, k, v, causal),
                            fa.flash_attention_plain(q, k, v, causal),
                            ATTENTION_TOL[dtype])
                ms = event_ms(lambda: fa.flash_attention(q, k, v, causal))
                lib_ms = event_ms(lambda: sdpa(q, k, v, causal))
                print(f"flash_attention B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                      f"{dtype} causal={causal}: err {err:.3g}, {ms:.4f} ms, "
                      f"SDPA {lib_ms:.4f} ms", flush=True)
    check_rms_norm(gen)
    for b, s, h, p, n, g, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_args(gen, b, s, h, p, n, g, dtype) + (chunk,)
            (y, st), (y_want, st_want) = sc.ssd_scan(*args), \
                sc.ssd_scan_plain(*args)
            err = close(y, y_want, SSD_TOL[dtype])
            st_err = close(st, st_want, 1e-3)
            ms = event_ms(lambda: sc.ssd_scan(*args))
            print(f"ssd_scan B={b} S={s} H={h} P={p} N={n} G={g} "
                  f"chunk={chunk} {dtype}: y err {err:.3g}, state err "
                  f"{st_err:.3g}, {ms:.4f} ms", flush=True)
    profile_ssd(gen)


def ssd_args(gen, b, s, h, p, n, g, dtype):
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    x = rnd(b, s, h, p).to(dtype)
    dt = 0.5 * rnd(b, s, h)
    a_log = torch.rand(h, generator=gen, device="cuda") * 1.5 - 1
    bb, cc = ((0.3 * rnd(b, s, g, n)).to(dtype) for _ in range(2))
    d_skip = torch.rand(h, generator=gen, device="cuda")
    dt_bias = torch.rand(h, generator=gen, device="cuda") - 0.5
    return x, dt, a_log, bb, cc, d_skip, dt_bias


def tie_input(n: int, block: int) -> torch.Tensor:
    """Blocks whose absmax is 127 (scale exactly 1) holding values at
    every .5 tie in [-127, 127], plus zeros."""
    ties = torch.arange(-254, 255, dtype=torch.float32) / 2
    x = ties.repeat(n // ties.numel() + 1)[:n].clone()
    x.view(-1, block)[:, 0] = 127.0
    return x.cuda()


def device_ops(fn, iters: int = 50):
    """(device ms by kernel name, device operations a call) of ``fn()``
    from the profiler over ``iters`` warm calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    by_name = {}
    for e in events:
        name = re.search(r"\w+_kernel|Memset|Memcpy", e.key)
        name = name.group() if name else e.key[:48]
        by_name[name] = by_name.get(name, 0.0) + \
            e.self_device_time_total / iters / 1e3
    return by_name, sum(e.count for e in events) / iters


def quantize_cases(gen, n: int, block: int, dtype):
    cases = {"random": (3 * torch.randn(n, generator=gen,
                                        device="cuda")).to(dtype),
             "zeros": torch.zeros(n, dtype=dtype, device="cuda")}
    if n <= 1 << 24:
        cases["ties"] = tie_input(n, block).to(dtype)
    if block == 100_003:          # x one element past 16-byte alignment
        buf = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        cases["misaligned"] = buf[1:]
    return cases


def check_quantize(gen) -> None:
    compile_report("quantize")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        grid = qz._max_grid(torch.device("cuda", 0), qz._DTYPES[dtype], True)
        print(f"quantize cooperative kernel {dtype}: {grid // sms} CTAs "
              f"resident an SM, grid up to {grid}", flush=True)
    for n, block in QUANTIZE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for label, x in quantize_cases(gen, n, block, dtype).items():
                q, s = qz.quantize(x, block)
                q_want, s_want = qz.quantize_plain(x, block)
                back = qz.dequantize(q, s, block, dtype)
                back_want = qz.dequantize_plain(q, s, block, dtype)
                torch.cuda.synchronize()
                same = (torch.equal(q, q_want) and torch.equal(s, s_want)
                        and torch.equal(back, back_want))
                if not same:
                    bad = int((q.int() - q_want.int()).abs().max())
                    raise AssertionError(
                        f"quantize n={n} block={block} {dtype} {label}: not "
                        f"bit-identical (max |dq| {bad})")
                ms = event_ms(lambda: qz.quantize(x, block))
                dms = event_ms(lambda: qz.dequantize(q, s, block, dtype))
                print(f"quantize n={n} block={block} {dtype} {label}: "
                      f"identical, quantize {ms:.4f} ms, dequantize "
                      f"{dms:.4f} ms", flush=True)
    n, block = QUANTIZE_MAIN
    x = 1e-3 * torch.randn(n, generator=gen, device="cuda")
    q, s = qz.quantize(x, block)
    q_want, s_want = qz.quantize_plain(x, block)
    torch.cuda.synchronize()
    if not (torch.equal(q, q_want) and torch.equal(s, s_want)):
        raise AssertionError("quantize at the main shape: not bit-identical")
    by_name, per_call = device_ops(lambda: qz.quantize(x, block))
    ms = event_ms(lambda: qz.quantize(x, block), 20)
    print(f"quantize n={n} block={block} float32: identical, {ms:.4f} ms, "
          f"{per_call:g} device ops a call, device "
          f"{sum(by_name.values()):.4f} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_name.items()),
          flush=True)


def grad_error(kernel_out, plain_out, inputs) -> float:
    """Max |d| between the gradients of the kernel and plain outputs
    (a fixed random cotangent) with respect to ``inputs``."""
    outs_k = kernel_out if isinstance(kernel_out, tuple) else (kernel_out,)
    outs_p = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    cots = [torch.randn_like(o) for o in outs_p]
    gk = torch.autograd.grad(outs_k, inputs, cots)
    gp = torch.autograd.grad(outs_p, inputs, cots)
    for a in outs_k:
        if a.grad_fn is None:
            raise AssertionError("a kernel output has no grad_fn")
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
               for a, b in zip(gk, gp))


def check_grad(gen) -> None:
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    x, r = rnd(64, 2048), rnd(64, 2048)
    w = 1 + 0.1 * rnd(2048)
    q, k, v = rnd(1, 256, 16, 128), rnd(1, 256, 8, 128), rnd(1, 256, 8, 128)
    ssd = ssd_args(gen, 1, 512, 8, 64, 128, 1, torch.float32)
    cases = {
        "rms_norm": ((x, w), lambda x, w: rn.rms_norm(x, w),
                     lambda x, w: rn.rms_norm_plain(x, w)),
        "rms_norm_residual": ((x, r, w), rn.rms_norm_residual,
                              rn.rms_norm_residual_plain),
        "flash_attention": ((q, k, v), fa.flash_attention,
                            fa.flash_attention_plain),
        "ssd_scan": (ssd, lambda *t: sc.ssd_scan(*t, 256),
                     lambda *t: sc.ssd_scan_plain(*t, 256)),
    }
    for name, (inputs, kernel, plain) in cases.items():
        inputs = tuple(t.detach().requires_grad_() for t in inputs)
        err = grad_error(kernel(*inputs), plain(*inputs), inputs)
        if err > 1e-3:
            raise AssertionError(f"{name} gradient off by {err:.3g} of max")
        print(f"grad {name}: max error {err:.3g} of the largest gradient",
              flush=True)


def smc_extreme_lanes(n: int, window: int, seed: int):
    """Lanes within 2W of INT32_MAX, INT32_MIN and 0, published <= 0 and
    in (0, W), and arbitrary int32 lanes, with a validity mask (as
    ``tests/test_torch_smc_sweep.py`` builds them)."""
    g = torch.Generator().manual_seed(seed)
    i32 = torch.iinfo(torch.int32)
    base = torch.tensor([i32.max, i32.min, 0], dtype=torch.int64)[
        torch.randint(0, 3, (n,), generator=g)]
    near = lambda: base + torch.randint(-2 * window, 2 * window + 1, (n,),
                                        generator=g)
    wild = lambda: torch.randint(i32.min, i32.max, (n,), generator=g)
    processed, published = near(), near()
    small = torch.rand(n, generator=g) < 0.25
    published = torch.where(small, torch.randint(-window, window, (n,),
                                                 generator=g) + 1,
                            published)
    mix = torch.rand(n, generator=g) < 0.2
    processed = torch.where(mix, wild(), processed)
    published = torch.where(mix, wild(), published)
    clip = lambda t: t.clamp(i32.min, i32.max).to(torch.int32).cuda()
    valid = (torch.rand(n, generator=g) < 0.7).to(torch.int32).cuda()
    return clip(published), clip(processed), valid


def check_smc(gen) -> None:
    compile_report("smc_sweep")
    for label, n, window in (("group16", 256, 100), ("fig6_grid", 1280, 1000),
                             ("large", 1 << 20, 100),
                             ("extremes", 4099, 1000)):
        pub, proc, valid = smc_extreme_lanes(n, window, n + window)
        if label != "extremes":
            proc = torch.randint(0, 4 * window, (n,), device="cuda",
                                 generator=gen, dtype=torch.int32)
            pub = proc + torch.randint(-1, window + 2, (n,), device="cuda",
                                       generator=gen, dtype=torch.int32)
        for mask in (None, valid):
            got = ss.smc_sweep_watermark(pub, proc, window=window,
                                         valid=mask)
            twin = ss.smc_sweep_watermark_plain(pub, proc, window, mask)
            form = ss.smc_sweep_watermark_closed_form(pub, proc, window,
                                                      mask)
            if not (torch.equal(got, twin) and torch.equal(got, form)):
                raise AssertionError(f"smc_sweep_watermark {label} differs")
            ms = event_ms(lambda: ss.smc_sweep_watermark(
                pub, proc, window=window, valid=mask), 200)
            yard = event_ms(lambda: proc + torch.clamp(pub - proc, 0,
                                                       window), 200)
            print(f"smc_sweep_watermark {label} {n} lanes W={window} "
                  f"{'masked' if mask is not None else 'unmasked'}: exact, "
                  f"{ms:.4f} ms, three-op closed form {yard:.4f} ms",
                  flush=True)
        counters = ss.counters_from_counts(pub, window).contiguous()
        got = ss.smc_sweep(counters, proc)
        if not (torch.equal(got, ss.smc_sweep_plain(counters, proc))
                and torch.equal(got, ss.smc_sweep_watermark(
                    pub, proc, window=window))):
            raise AssertionError(f"smc_sweep (ring) {label} differs")
        by_name, per_call = device_ops(lambda: ss.smc_sweep(counters, proc),
                                       50)
        print(f"smc_sweep ring {label} {n} rows W={window}: exact, "
              f"{event_ms(lambda: ss.smc_sweep(counters, proc), 200):.4f} "
              f"ms, device {sum(by_name.values()) * 1e3:.2f} us, "
              f"{per_call:g} device ops a call", flush=True)


SECTIONS = {"decode": check_decode, "forward": check_forward,
            "quantize": check_quantize, "grad": check_grad,
            "smc": check_smc}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("selfcheck: no CUDA device", file=sys.stderr)
        return 2
    names = (sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        SECTIONS[name](gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
