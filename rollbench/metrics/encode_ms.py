"""encode_ms (ms): the span groth16.encode a proof (the witness to
Montgomery limbs on the device: w % r, ints_to_limbs, the copy to the
card, to_mont), the median over the window's proofs that were not
profiled (rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    return median_ms(["groth16.encode"]) if run.unit == "proof" else None
