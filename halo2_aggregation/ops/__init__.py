"""Device compute: batched limb field arithmetic, curve ops, the scalar-mul
ladder (CUDA on the GPU), MSM, NTT."""
