"""Minimal R1CS constraint system.

Frozen copy of the port's R1CS: the subset of
``ark-relations``/``ark-r1cs-std`` the Rust reference uses (its
``src/backend/snark.rs:7-9``): field variables, inputs vs witnesses,
``a*b=c`` constraints, and linear combinations — enough for the two fixed
circuits (equality, membership). Variables: index 0 is the constant ONE,
then instance variables in allocation order, then witnesses (the Groth16 QAP
indexing convention).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .field import BN254_FR

R = BN254_FR.p

LC = Dict[int, int]  # variable index -> coefficient (mod r)

ONE = 0  # variable 0 is the constant 1


class ConstraintSystem:
    def __init__(self):
        self.instance: List[int] = []  # values (excluding ONE)
        self.witness: List[int] = []
        self.constraints: List[Tuple[LC, LC, LC]] = []
        self._witness_base: Optional[int] = None

    # -- allocation (all inputs must be allocated before any witness is
    #    *indexed*; we allow interleaved allocation and resolve at the end) --
    def new_input(self, value: int) -> int:
        """Allocate a public input; returns a temporary tag."""
        self.instance.append(value % R)
        return -(len(self.instance))  # negative tags: -1.. for instance

    def new_witness(self, value: int) -> int:
        self.witness.append(value % R)
        return len(self.witness)  # positive tags: 1.. for witness

    @property
    def num_instance(self) -> int:
        return len(self.instance) + 1  # + ONE

    @property
    def num_witness(self) -> int:
        return len(self.witness)

    @property
    def num_variables(self) -> int:
        return self.num_instance + self.num_witness

    def _resolve(self, var: int) -> int:
        """Map tag -> global QAP index ([one] + instance + witness)."""
        if var == ONE:
            return 0
        if var < 0:
            return -var  # instance i -> index i
        return len(self.instance) + var  # witness j -> num_instance-1 + j + 1

    def lc(self, *terms) -> LC:
        """Build a linear combination from (coeff, var) pairs or a constant.

        Keys are variable *tags* (0=ONE, negative=instance, positive=witness),
        resolved to global QAP indices lazily — allocation order of inputs vs
        witnesses is then irrelevant, like arkworks' separate index spaces.
        """
        out: LC = {}
        for t in terms:
            if isinstance(t, tuple):
                coeff, var = t
            else:
                coeff, var = t, ONE
            out[var] = (out.get(var, 0) + coeff) % R
        return {k: v for k, v in out.items() if v}

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """Add constraint <a,z> * <b,z> = <c,z>."""
        self.constraints.append((a, b, c))

    # -- assignment --------------------------------------------------------
    def full_assignment(self) -> List[int]:
        return [1] + list(self.instance) + list(self.witness)

    def eval_lc(self, lc: LC, z: List[int]) -> int:
        acc = 0
        for tag, coeff in lc.items():
            acc = (acc + coeff * z[self._resolve(tag)]) % R
        return acc

    def is_satisfied(self) -> bool:
        z = self.full_assignment()
        for a, b, c in self.constraints:
            if self.eval_lc(a, z) * self.eval_lc(b, z) % R != self.eval_lc(c, z):
                return False
        return True

    # -- gadget helpers (FpVar / Boolean equivalents) ----------------------
    def mul(self, a_var: int, a_val: int, b_var: int, b_val: int) -> Tuple[int, int]:
        """Witness the product a*b (1 constraint). Returns (var, value)."""
        val = a_val * b_val % R
        out = self.new_witness(val)
        self.enforce(self.lc((1, a_var)), self.lc((1, b_var)), self.lc((1, out)))
        return out, val

    def enforce_equal(self, a: LC, b: LC) -> None:
        """<a,z> == <b,z> as (a-b) * 1 = 0."""
        diff = dict(a)
        for k, v in b.items():
            diff[k] = (diff.get(k, 0) - v) % R
        diff = {k: v for k, v in diff.items() if v}
        self.enforce(diff, self.lc((1, ONE)), {})

    def new_boolean_witness(self, value: bool) -> int:
        """Allocate a witness bit with the booleanity constraint b*(b-1)=0."""
        var = self.new_witness(1 if value else 0)
        self.enforce(
            self.lc((1, var)), self.lc((1, var), (R - 1, ONE)), {}
        )
        return var

    def new_boolean_input(self, value: bool) -> int:
        """Allocate a public-input bit with booleanity constraint."""
        var = self.new_input(1 if value else 0)
        self.enforce(
            self.lc((1, var)), self.lc((1, var), (R - 1, ONE)), {}
        )
        return var
