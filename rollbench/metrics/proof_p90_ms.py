"""proof_p90_ms (ms): the 90th percentile (nearest rank) of every
completed proof call's latency in the window: the entry's call to its
return, the self-verify (and for the withdraw circuit the witness)
included."""

from rollbench.harness import percentile


def read(run):
    lat = [c["latency_s"] for c in run.done()]
    if run.unit != "proof" or not lat:
        return None
    return percentile(lat, 90) * 1e3
