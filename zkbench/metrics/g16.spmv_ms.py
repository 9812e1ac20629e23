"""The Groth16 h's native sparse products, in ms a batch: the program's span
``g16.h.spmv`` (one ``groth16_spmv`` call a distinct statement)."""

from zkbench.program_spans import ms_per_batch


def read(trace):
    return ms_per_batch(trace, "g16.h.spmv")
