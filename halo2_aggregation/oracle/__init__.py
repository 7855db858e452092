"""Pure-Python (bigint) CPU oracle implementations.

Every device op in :mod:`halo2_aggregation.ops` is unit-tested against
these — the test strategy SURVEY.md §4 calls for ("field/curve kernel unit
tests against a trusted CPU oracle"). They are also used directly for the
once-per-aggregate host-side pairing check, which the reference likewise
performs outside the circuit (`src/multiopen.rs:494-508`,
deferred pairing).
"""
