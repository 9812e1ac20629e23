"""Proof schemes (this slice: the range proof, scheme 1)."""
