"""The multiples tables built on the card, in ms a run: the program's spans
``table.build`` from the metric files' import to the window's end, so the
warm-up batch's cold builds and any rebuild inside the window."""

from zkbench.program_spans import ms_until_window_end


def read(trace):
    return ms_until_window_end(trace, "table.build")
