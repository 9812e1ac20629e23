"""The range batch prover's time a batch: the span around prove_prepared."""

SPANS = [("bp.prove", "libzkp_tpu_torch.parallel.batch_prover", "prove_prepared")]


def read(trace):
    return trace.span_ms_per_batch("bp.prove")
