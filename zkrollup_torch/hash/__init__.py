"""Batched hashes over BN254 Fr on torch tensors (the MiMCSponge of the
rollup's trees and leaves): mimc.py."""
