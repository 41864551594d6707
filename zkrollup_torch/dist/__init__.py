"""The multi-device prover of the port: the mesh and the sharded MSM, NTT
and quotient (mesh.py), and the multi-process bring-up (launch.py)."""
