"""The range batch prover's phases that launch no kernel, in ms a batch:
the program's spans ``bp.draw`` (the draws and their wide reductions),
``bp.digits`` (the V, A and S digit bytes and their upload), ``bp.upload``
(the limb columns) and ``bp.envelope`` (each proof's wire bytes)."""

from zkbench.program_spans import ms_per_batch


def read(trace):
    return ms_per_batch(trace, "bp.draw", "bp.digits", "bp.upload", "bp.envelope")
