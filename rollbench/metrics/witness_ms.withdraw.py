"""witness_ms.withdraw (ms): the mean of ProveStats.witness_s of
WithdrawProver.prove_withdraw (the witness synthesis inside the timed
call), over the window's proofs that were not profiled."""


def read(run):
    xs = [c["witness_s"] for c in run.untraced()]
    if run.unit != "proof" or run.config.get("circuit") != "withdraw" \
            or not xs:
        return None
    return sum(xs) / len(xs) * 1e3
