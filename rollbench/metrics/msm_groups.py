"""msm_groups (groups): the groth16.msm_group spans a proof (the MSMs'
window groups, each sized to the card's free memory: one a curve where
every window fits), the median over the window's proofs that were not
profiled. None where the program opens no such span."""

import statistics

from rollbench.program_spans import finished

NAME = "groth16.msm_group"


def read(run):
    found = finished() if run.unit == "proof" else None
    if not found:
        return None
    by_trace = {}
    for s in found:
        if s.trace is not None:
            by_trace.setdefault(s.trace, []).append(s)
    counts = [sum(s.name == NAME for s in group)
              for group in by_trace.values()
              if not any(s.profiled for s in group)]
    counts = [n for n in counts if n]
    return float(statistics.median(counts)) if counts else None
