"""proofs_per_s (proofs/s): self-verified proofs completed in the window
over the window's seconds (its start to the end of its last proof). A proof
that failed counts in neither."""


def read(run):
    if run.unit != "proof" or run.window_s <= 0:
        return None
    return len(run.done()) / run.window_s
