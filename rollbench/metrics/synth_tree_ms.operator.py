"""synth_tree_ms.operator (ms): the spans synth.tree a batch (the four
leaf hashes, the two existence proofs and the two root recomputations,
in the witness worker, one a transfer), summed, the median over the
batches that were not profiled (rollbench/program_spans.py)."""

from rollbench.program_spans import median_ms


def read(run):
    return median_ms(["synth.tree"]) if run.unit == "batch" else None
