"""verify_ms (ms): the mean of ProveStats.verify_s, the program's host
clock around the self-verify's groth16.verify, over the window's proofs
that were not profiled."""


def read(run):
    xs = [c["verify_s"] for c in run.untraced()]
    if run.unit != "proof" or not xs:
        return None
    return sum(xs) / len(xs) * 1e3
