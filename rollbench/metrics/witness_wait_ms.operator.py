"""witness_wait_ms.operator (ms): the span operator.wait_witness a batch
(run_pipeline's prove thread waiting for the witness worker's batch),
the median over the batches that were not profiled
(rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    if run.unit != "batch":
        return None
    return median_ms(["operator.wait_witness"])
