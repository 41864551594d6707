"""blind_ms (ms): the span groth16.blind a proof (the blinding combine,
single-point operations on the host), the median over the window's
proofs that were not profiled (rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    return median_ms(["groth16.blind"]) if run.unit == "proof" else None
