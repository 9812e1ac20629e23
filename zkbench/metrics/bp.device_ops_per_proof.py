"""Device operations (kernels, copies, sets) that start inside the range
batch prover's spans, per Bulletproofs proof."""

from zkbench.reference.verify import BP_KINDS

SPANS = [("bp.prove", "libzkp_tpu_torch.parallel.batch_prover", "prove_prepared")]


def read(trace):
    spans = trace.named("bp.prove")
    proofs = sum(trace.proofs.get(k, 0) for k in BP_KINDS)
    if not spans or not proofs:
        return None
    return len(trace.events_in(spans)) / proofs
