"""The decoder's FLOPs of every prompt and output token the window
processed, over the window's wall and the card's bf16 peak, in percent."""

from yardstick.flops import PEAKS


def read(run):
    flops = run.counters.get("flops", 0.0)
    if not flops:
        return None
    return 100.0 * flops / run.wall_s / PEAKS["bf16_flops_per_s"]
