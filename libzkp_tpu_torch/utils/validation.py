"""Per-proof-type input predicates.

Mirrors ``reference utils/validation.rs`` (messages kept close so
error-handling callers see familiar text).
"""

from __future__ import annotations

from typing import Sequence

from .encoding import check_u64
from .errors import InvalidInput


def is_ascending_order(values: Sequence[int]) -> bool:
    """Monotonic non-decreasing (duplicates allowed) — proof_helpers.rs:139-141."""
    return all(values[i] <= values[i + 1] for i in range(len(values) - 1))


def safe_sum(values: Sequence[int]) -> int:
    """Sum with u64 overflow check (proof_helpers.rs:144-151)."""
    acc = 0
    for v in values:
        acc += v
        if acc > 0xFFFFFFFFFFFFFFFF:
            raise InvalidInput("integer overflow in sum calculation")
    return acc


def validate_range_params(value: int, min_v: int, max_v: int) -> None:
    check_u64(value, "value")
    check_u64(min_v, "min")
    check_u64(max_v, "max")
    if min_v > max_v:
        raise InvalidInput("min cannot be greater than max")
    if value < min_v or value > max_v:
        raise InvalidInput(f"value {value} is not in range [{min_v}, {max_v}]")


def validate_equality_params(val1: int, val2: int) -> None:
    check_u64(val1, "val1")
    check_u64(val2, "val2")
    if val1 != val2:
        raise InvalidInput("values are not equal")


def validate_threshold_params(values: Sequence[int], threshold: int) -> int:
    check_u64(threshold, "threshold")
    if len(values) == 0:
        raise InvalidInput("values cannot be empty")
    for v in values:
        check_u64(v, "value")
    total = safe_sum(values)
    if total < threshold:
        raise InvalidInput(f"sum {total} is less than threshold {threshold}")
    return total


def validate_membership_params(value: int, the_set: Sequence[int]) -> None:
    check_u64(value, "value")
    if len(the_set) == 0:
        raise InvalidInput("set cannot be empty")
    for v in the_set:
        check_u64(v, "set element")
    if value not in list(the_set):
        raise InvalidInput(f"value {value} is not in the provided set")


def validate_improvement_params(old: int, new: int) -> int:
    check_u64(old, "old")
    check_u64(new, "new")
    if new <= old:
        raise InvalidInput("new value must be greater than old value")
    return new - old


def validate_consistency_params(data: Sequence[int]) -> None:
    if len(data) == 0:
        raise InvalidInput("data cannot be empty")
    for v in data:
        check_u64(v, "data element")
    if not is_ascending_order(data):
        raise InvalidInput("data is not monotonic non-decreasing")


def validate_set_size(the_set: Sequence[int], max_size: int) -> None:
    if len(the_set) > max_size:
        raise InvalidInput(
            f"set size {len(the_set)} exceeds maximum allowed size {max_size}"
        )
