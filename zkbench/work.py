"""The yardstick of the kernels' roofline shares: the work the algorithm of a
call needs, counted from the shapes of its arguments, and the least time the
card could take for it. Frozen, so that a kernel's redesign does not move
it.

Counting, as PERF.md's Bound paragraph counts it: a field product is a
schoolbook 24 x 24 limb convolution plus its fold, 576 + 52 multiply-adds
mod 2^255 - 19 and 576 + 624 for the BN254 base field; an Edwards padd is 9
products; a BN254 G2 padd 42 (14 Fq2 products of 3). A window sum of ``Kp``
points a lane is ``Kp - 1`` padds a lane. Bytes: each gathered table row,
digit and output word once.
"""

from __future__ import annotations

ED_MUL_MACS = 24 * 24 + 52
BN_MUL_MACS = 24 * 24 + 26 * 24
PADD_MACS = {"ed25519": 9 * ED_MUL_MACS, "bn254_g2": 42 * BN_MUL_MACS}
OUT_WORDS = {"ed25519": 4 * 24, "bn254_g2": 6 * 24}


def window_sum_work(curve: str, digits_shape: tuple, row_bytes: int) -> tuple:
    """(multiply-adds, bytes) of one window-sum call: ``digits_shape`` is
    ``(Kp, B)`` (``window_sum``) or ``(windows, Kp, B)`` (``window_sum4``)."""
    *windows, kp, b = digits_shape
    lanes = b * (windows[0] if windows else 1)
    macs = (kp - 1) * PADD_MACS[curve] * lanes
    nbytes = kp * lanes * (row_bytes + 4) + lanes * OUT_WORDS[curve] * 4
    return macs, nbytes


def least_seconds(macs: float, nbytes: float, peaks: dict) -> float:
    """The larger of the multiply-adds at the card's int32 rate and the
    bytes at its memory bandwidth."""
    rate = peaks["sms"] * peaks["int32_lanes_per_sm"] * peaks["clock_hz"]
    return max(macs / rate, nbytes / peaks["hbm_bytes_per_s"])
