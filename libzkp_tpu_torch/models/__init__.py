"""The Bulletproofs range prover: host golden prover and verifier, the batched
device prover, the backend envelopes and the range scheme."""
