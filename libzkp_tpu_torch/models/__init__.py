"""The provers: the Bulletproofs range prover (host golden prover and
verifier, the batched device prover, the backend envelopes) and the Groth16
equality prover (R1CS, setup, batched prover, verifier, the SNARK backend),
with their schemes."""
