"""The Groth16 finish, in ms a batch: the program's span ``g16.finish``
(every proof's blinding and fold after the query MSMs, grouped and
single)."""

from zkbench.program_spans import ms_per_batch


def read(trace):
    return ms_per_batch(trace, "g16.finish")
