"""Launch-path time of three small kernel calls of the port, from the
checkout at argv[1] (its ``src/`` on the path): the CUDA-event mean over
5000 back-to-back calls of ``smc_sweep_watermark`` (256 lanes),
``rms_norm`` (128 x 128 bf16) and ``flash_decode`` (the serve shape),
each after 200 warm-up calls.  One JSON line.  To compare two commits on
one card, unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and run the two in turns in one call:

    for t in build/parent . . build/parent; do
        python3 tools/launch_path_ab.py $t; done
"""
import json
import sys

sys.path.insert(0, sys.argv[1] + "/src")

import torch  # noqa: E402

from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import smc_sweep as ss  # noqa: E402


def ms(fn, iters=5000):
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    g = torch.Generator(device="cuda").manual_seed(0)
    pub = torch.randint(0, 100, (256,), device="cuda", dtype=torch.int32)
    proc = torch.randint(0, 100, (256,), device="cuda", dtype=torch.int32)
    x = torch.randn(128, 128, generator=g, device="cuda").bfloat16()
    w = torch.ones(128, device="cuda").bfloat16()
    q = torch.randn(8, 16, 128, generator=g, device="cuda").bfloat16()
    k = torch.randn(8, 2048, 8, 128, generator=g, device="cuda").bfloat16()
    kv = torch.full((8,), 30, dtype=torch.int32, device="cuda")
    out = {"tree": sys.argv[1],
           "watermark_ms": ms(lambda: ss.smc_sweep_watermark(
               pub, proc, window=100)),
           "rms_norm_ms": ms(lambda: rn.rms_norm(x, w)),
           "flash_decode_ms": ms(lambda: fd.flash_decode(q, k, k, kv))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
