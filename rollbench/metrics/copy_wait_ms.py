"""copy_wait_ms (ms): the spans groth16.copy_wait a proof (the host
waiting for the G1 and the G2 window sums' copies, so for the card),
summed, the median over the window's proofs that were not profiled
(rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    return median_ms(["groth16.copy_wait"]) if run.unit == "proof" else None
