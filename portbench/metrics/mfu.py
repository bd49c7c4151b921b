"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's calls (``portbench.roofline``, recomputation never counted) over
the window's time, over 989 TFLOP/s, in %."""

from portbench import roofline


def read(run):
    return 100.0 * run.flops / run.window_s / roofline.BF16_FLOPS_PER_S
