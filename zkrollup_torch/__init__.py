"""zkrollup_torch: the BN254 Groth16 rollup prover on PyTorch and CUDA.

The port of the `zkrollup` package (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for Hopper. `zkrollup` stays the reference: each
module here names its counterpart there. The package imports torch, never
jax, and nothing of `zkrollup`: the jax-free modules it needs from there
(ref, r1cs, witness.assembler, tree.merkle, tree.store, config,
native.engine, chain, the operator loop and cli) have copies here, and the
native engine builds into build/native/.
"""
