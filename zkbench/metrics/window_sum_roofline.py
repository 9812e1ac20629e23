"""K1 ``window_sum`` (ed25519, the range prover's MSMs): the least time of
its calls over its device time, in percent."""

from zkbench.trace import roofline_percent

CALLS = [("window_sum", "libzkp_tpu_torch.ops.kernels", "window_sum")]


def read(trace):
    return roofline_percent(trace, "window_sum", "ed25519", "window_sum_kernel")
