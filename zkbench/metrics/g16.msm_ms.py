"""The Groth16 query MSMs' time a batch: the span around
``groth16._accs_many``."""

SPANS = [("g16.msm", "libzkp_tpu_torch.models.groth16", "_accs_many")]


def read(trace):
    return trace.span_ms_per_batch("g16.msm")
