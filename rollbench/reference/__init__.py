"""The benchmark's plain reference: pure Python over ints, importing
nothing of the program (zkrollup_torch), of the JAX package or of torch.

Frozen copies of the program's host modules as they stood at commit
f14ca18 (each file says which): BN254 and BabyJubJub arithmetic, MiMC,
EdDSA, the circuit synthesis (builder, gadgets, circuits), the Merkle tree
and the batch input assembly. The native dispatch of `mimc.multi_hash`
and `babyjubjub.mul` is cut out: the copies run in Python alone.
groth16.py (proofs from the setup seed's toxic scalars) and state.py (the
rollup's state replayed) are the benchmark's own.
"""
