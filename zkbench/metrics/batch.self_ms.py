"""process_batch's own time a batch: its span less its bucket provers'."""

BP = "libzkp_tpu_torch.parallel.batch_prover"

# process_batch's bucket provers; the traced run's breakdown names idle
# time by these spans too
SPANS = [
    ("prehash", BP, "snark_commitments"),
    ("g16.equality", BP, "prove_equality_batch"),
    ("g16.membership", BP, "prove_membership_batch"),
    ("bp.prepare", BP, "_prepare"),
    ("bp.prove", BP, "prove_prepared"),
    ("stark", BP, "prove_improvement_batch"),
]


def read(trace):
    batches = trace.named("batch")
    if not batches:
        return None
    buckets = {name for name, _, _ in SPANS}
    inner = sum(s[2] - s[1] for s in trace.spans if s[0] in buckets)
    return (sum(s[2] - s[1] for s in batches) - inner) / 1e6 / len(batches)
