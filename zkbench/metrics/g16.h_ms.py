"""The Groth16 h pipeline's time a batch (the native sparse products and the
device NTTs): the span around ``groth16._h_many``."""

SPANS = [("g16.h", "libzkp_tpu_torch.models.groth16", "_h_many")]


def read(trace):
    return trace.span_ms_per_batch("g16.h")
