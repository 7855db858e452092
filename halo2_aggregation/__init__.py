"""halo2_aggregation — a halo2 proof-aggregation framework in JAX.

A from-scratch JAX re-design of the capabilities of
Trapdoor-Tech/halo2-aggregation: BN254
non-native limb field arithmetic, EC ops and MSM as batched device ops,
a full halo2-style PLONK proving system (KZG + GWC multiopen), the native
verifier algebra producing the deferred-pairing `(w, zw, f, e)` quad, and
an in-circuit verifier for true proof aggregation.

Layering (bottom-up):
  ops/          batched limb arithmetic, curve ops, MSM, NTT, the CUDA ladder
  oracle/       pure-Python bigint reference (tests + host pairing)
  utils/        Blake2b transcript, serialization, profiling
  plonk/        constraint system, keygen, prover, verifier, KZG
  aggregation/  backend-abstracted in-circuit verifier + gadgets
  models/       circuits: simple-example inner circuit, aggregation circuit
  parallel/     mesh-sharded MSM, batched multi-proof verification
"""

__version__ = "0.1.0"
