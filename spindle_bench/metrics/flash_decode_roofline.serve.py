"""Flash decode's share of its roofline in the traced segment: the least
time its valid rows and lengths need (bytes at the HBM rate, operations
at the bf16 peak) over the device time of its split and merge kernels."""

from yardstick import device
from yardstick.flops import PEAKS, roofline_seconds


def read(run):
    if run.trace is None:
        return None
    n, sec = device.op_seconds(run.trace, "flash_decode_split_kernel",
                               "flash_decode_merge_kernel")
    c = run.trace["counters"]
    if not n or not c.get("decode_bytes"):
        return None
    need = roofline_seconds(c["decode_bytes"], c["decode_flops"],
                            PEAKS["bf16_flops_per_s"])
    return 100.0 * need / sec
