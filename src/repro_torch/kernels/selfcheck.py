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
  kernel's registers and spills (and the count of ``HGMMA`` tensor-core
  instructions in each attention kernel's machine code); checks one tile
  of the bfloat16 attention kernel's tensor-core steps (``q k^T`` and
  ``bf16(q k^T) v`` through the ``wgmma`` operand layouts) against plain
  products at D = 32, 64 and 128; then holds flash attention, the SSD
  scan and ``rms_norm`` against their plain versions at the forward and
  serve paths' shapes and at the ``tests/test_kernels.py`` shapes, in
  float32 and bfloat16, with the time of one library call beside each
  attention and ``rms_norm`` case;
* ``quantize`` — the same for ``csrc/quantize.cu``: quantize and
  dequantize must equal their plain versions bit for bit (the
  ``tests/test_quantize_kernel.py`` shapes, 2**24 elements, one block of
  2**26, zeros and exact .5 ties);
* ``grad`` — the gradient through each forward kernel site (RMSNorm,
  fused residual RMSNorm, flash attention, SSD scan) against plain
  autograd of its plain version, float32.

It prints the largest error and the CUDA-event time of each case and
fails on a compile error or an error above the bars.  Meant as the
first, short call after a kernel changes, before a full
``chip_smoke.py`` run.  Needs a CUDA GPU and ``nvcc``; exits 2 without a
GPU.
"""

from __future__ import annotations

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
from repro_torch.kernels import ssd_scan as sc

ATTENTION_SHAPES = ((2, 2048, 16, 8, 128), (1, 1000, 16, 8, 128),
                    (1, 384, 8, 1, 128), (2, 128, 6, 2, 32),
                    (2, 200, 4, 2, 64), (4, 512, 16, 8, 128))
SSD_SHAPES = ((1, 2048, 80, 64, 128, 1, 256), (1, 64, 2, 16, 16, 1, 16),
              (2, 128, 4, 32, 64, 2, 32), (1, 96, 2, 64, 128, 1, 32))
QUANTIZE_SHAPES = ((2048, 2048), (8192, 2048), (4096, 512), (1 << 24, 2048),
                   (1 << 26, 1 << 26), (3 * 5000, 5000))
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


def compile_report(name: str, keep=()) -> None:
    """nvcc's -Xptxas -v lines (registers, spills) for ``csrc/<name>.cu``
    (of the kernels whose names hold one of ``keep``, where given) and,
    where the toolkit has ``cuobjdump``, the count of HGMMA (``wgmma``)
    instructions in each kernel's machine code."""
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
            for fn, count in sass_opcode_counts(sass, "HGMMA").items():
                print(f"{name}: {fn}: {count} HGMMA instructions")


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
    for d in fa.HEAD_DIMS:
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


def check_forward(gen) -> None:
    for name in ("flash_attention", "ssd_scan", "rmsnorm"):
        compile_report(name)
    check_tiles(gen)
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


def check_quantize(gen) -> None:
    compile_report("quantize")
    for n, block in QUANTIZE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases = {"random": (3 * torch.randn(n, generator=gen,
                                                device="cuda")).to(dtype),
                     "zeros": torch.zeros(n, dtype=dtype, device="cuda")}
            if n <= 1 << 24:
                cases["ties"] = tie_input(n, block).to(dtype)
            for label, x in cases.items():
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


SECTIONS = {"decode": check_decode, "forward": check_forward,
            "quantize": check_quantize, "grad": check_grad}


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
