"""mfu.prove (%): the whole proof's share of the card's peak: the least
device time of its MSMs and quotient transforms (rollbench/workmodel.py)
over the traced window's wall a proof call (host clock, the self-verify
included). It bounds the MSM rooflines' claims: a kernel taken off the
path leaves its roofline silent, not this."""

from rollbench import workmodel


def read(run):
    t = run.trace
    if t is None or run.unit != "proof" or not t.calls or t.wall_s <= 0:
        return None
    return 100 * workmodel.proof_seconds(run.config) / (t.wall_s / t.calls)
