"""synth_signature_ms.operator (ms): the spans synth.signature a batch
(the EdDSA gadget with its message hash, in the witness worker, one a
transfer), summed, the median over the batches that were not profiled
(rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    return median_ms(["synth.signature"]) if run.unit == "batch" else None
