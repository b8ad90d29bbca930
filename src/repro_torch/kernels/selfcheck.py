"""Quick check of the forward path's CUDA kernels on one card.

    PYTHONPATH=src python -m repro_torch.kernels.selfcheck

Compiles ``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` with
``nvcc -Xptxas -v`` and prints each kernel's registers and spills, then
holds both kernels against their plain versions at the forward path's
shapes and at the ``tests/test_kernels.py`` shapes, in float32 and
bfloat16, printing the largest error and the CUDA-event time of each.
It fails on a compile error or an error above the test bars.  Meant as
the first, short call after a kernel changes, before a full
``chip_smoke.py`` run.  Needs a CUDA GPU and ``nvcc``; exits 2 without a
GPU.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as sc

ATTENTION_SHAPES = ((2, 2048, 16, 8, 128), (1, 1000, 16, 8, 128),
                    (1, 384, 8, 1, 128), (2, 128, 6, 2, 32),
                    (2, 200, 4, 2, 64), (4, 512, 16, 8, 128))
SSD_SHAPES = ((1, 2048, 80, 64, 128, 1, 256), (1, 64, 2, 16, 16, 1, 16),
              (2, 128, 4, 32, 64, 2, 32), (1, 96, 2, 64, 128, 1, 32))
ATTENTION_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


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


def compile_report(name: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name}: {line.strip()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("selfcheck: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    for name in ("flash_attention", "ssd_scan"):
        compile_report(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    for b, s, hq, hkv, d in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rnd(b, s, h, d).to(dtype) for h in (hq, hkv, hkv))
            for causal in (True, False):
                err = close(fa.flash_attention(q, k, v, causal),
                            fa.flash_attention_plain(q, k, v, causal),
                            ATTENTION_TOL[dtype])
                ms = event_ms(lambda: fa.flash_attention(q, k, v, causal))
                print(f"flash_attention B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                      f"{dtype} causal={causal}: err {err:.3g}, {ms:.4f} ms",
                      flush=True)
    for b, s, h, p, n, g, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(b, s, h, p).to(dtype)
            dt = 0.5 * rnd(b, s, h)
            a_log = torch.rand(h, generator=gen, device="cuda") * 1.5 - 1
            bb, cc = ((0.3 * rnd(b, s, g, n)).to(dtype) for _ in range(2))
            d_skip = torch.rand(h, generator=gen, device="cuda")
            dt_bias = torch.rand(h, generator=gen, device="cuda") - 0.5
            args = (x, dt, a_log, bb, cc, d_skip, dt_bias, chunk)
            (y, st), (y_want, st_want) = sc.ssd_scan(*args), \
                sc.ssd_scan_plain(*args)
            err = close(y, y_want, SSD_TOL[dtype])
            st_err = close(st, st_want, 1e-3)
            ms = event_ms(lambda: sc.ssd_scan(*args))
            print(f"ssd_scan B={b} S={s} H={h} P={p} N={n} G={g} "
                  f"chunk={chunk} {dtype}: y err {err:.3g}, state err "
                  f"{st_err:.3g}, {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
