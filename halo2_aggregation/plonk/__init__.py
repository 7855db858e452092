"""A halo2-style PLONK proving system (KZG + GWC multiopen).

This supplies everything the reference imports from its private `halo2`
fork (SURVEY.md §2b): ConstraintSystem/Expression, keygen_vk/keygen_pk,
create_proof, a verify_proof that returns ``(ok, (e, f, w, zw))``, Setup
params, and a MockProver-equivalent — so the aggregation layer has real
proofs to aggregate and a native verifier to match bit-for-bit.
"""

from .circuit import (
    Any,
    Column,
    ConstraintSystem,
    Expression,
    Rotation,
    TableAssignment,
    Assignment,
)
