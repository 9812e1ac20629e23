"""``window_sum4`` on BN254 G2 (the Groth16 b_g2 query MSM): the least time
of its calls over its device time, in percent."""

from zkbench.trace import roofline_percent

CALLS = [("window_sum4", "libzkp_tpu_torch.ops.kernels", "window_sum4")]


def read(trace):
    return roofline_percent(trace, "window_sum4", "bn254_g2", "window_sum4_g2_kernel")
