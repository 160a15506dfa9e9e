"""valida_tpu_torch: the Valida STARK prover's trace commit and polynomial
commitment scheme (FRI, Fiat-Shamir, Merkle openings) in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Field words live on the device as torch.int32 (every BabyBear word is below
p < 2^31); Keccak words and digests are full u32 values kept as their int32
bit patterns.  A CUDA tensor always runs the CUDA kernel; only a CPU tensor
runs a kernel's plain PyTorch version.

(The benchmark's frozen copy of the port's verifier.  Of each module it
keeps only what the verifier reaches on CPU tensors, imports included:
the chips' shapes, interactions and constraints, the program chip's
preprocessed trace, the transcript, the Merkle and FRI checks and the
proof's decoding.  The copied docstrings still describe the port's modules
whole.)
"""
