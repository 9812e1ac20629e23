"""The share of the traced window in which no operation ran on the card, in
percent."""


def read(trace):
    if trace.window_s <= 0 or not trace.device_events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
