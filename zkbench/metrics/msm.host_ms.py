"""The MSM seam's host work, in ms a batch: the program's spans
``msm.digits`` (scalars to digit bytes, the padding, the upload) and
``msm.decode`` (the downloaded limbs to host points)."""

from zkbench.program_spans import ms_per_batch


def read(trace):
    return ms_per_batch(trace, "msm.digits", "msm.decode")
