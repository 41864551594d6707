"""combine_ms (ms): the spans groth16.combine_g1 and groth16.combine_g2
a proof (the Horner combines of the window sums on the host), summed,
the median over the window's proofs that were not profiled
(rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    if run.unit != "proof":
        return None
    return median_ms(["groth16.combine_g1", "groth16.combine_g2"])
