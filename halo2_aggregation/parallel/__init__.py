"""Multi-chip scaling: mesh-sharded MSM and batched multi-proof verification.

The reference has no distributed machinery (SURVEY.md §2d) — this layer is
the scale-out story: proofs sharded over a `dp` mesh axis, MSM lanes over
`mp`, with XLA collectives between the devices.
"""
