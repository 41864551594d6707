"""l2_tx_per_s (tx/s): L2 transfers in the batches settled in the window
(proved, self-verified, accepted by the contract's roll_up, applied to the
operator's state) over the window's seconds (its start to the last batch
applied)."""


def read(run):
    if run.unit != "batch" or run.window_s <= 0:
        return None
    txs = sum(c["txs"] for c in run.done())
    return txs / run.window_s if txs else None
