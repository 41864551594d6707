"""witness_ms.operator (ms): the mean of PreparedBatch.witness_s (input
assembly and witness-only synthesis, timed in the daemon's worker process)
over the window's settled batches."""


def read(run):
    xs = [c["witness_s"] for c in run.done()]
    if run.unit != "batch" or not xs:
        return None
    return sum(xs) / len(xs) * 1e3
