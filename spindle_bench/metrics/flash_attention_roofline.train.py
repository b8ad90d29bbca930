"""The bf16 flash-attention forward kernel's share of its roofline in the
traced steps: the least time its causal products need (at the bf16 peak,
or its bytes at the HBM rate) over its device time.  The backward is no
kernel of the port (its gradient is the plain version's), so it is not
in this share."""

from yardstick import device
from yardstick.flops import PEAKS, flash_attention, roofline_seconds


def read(run):
    if run.trace is None:
        return None
    n, sec = device.op_seconds(run.trace, "flash_attention_kernel_bf16")
    if not n:
        return None
    t = run.traffic
    b, f = flash_attention(run.config, t["global_batch"], t["seq_len"],
                           backward=False)
    need = n * roofline_seconds(b, f, PEAKS["bf16_flops_per_s"])
    return 100.0 * need / sec
