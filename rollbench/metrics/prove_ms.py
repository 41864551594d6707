"""prove_ms (ms): the mean of ProveStats.prove_s, the program's host clock
around groth16.prove (which returns host integers, so the device's work is
inside it), over the window's proofs that were not profiled."""


def read(run):
    xs = [c["prove_s"] for c in run.untraced()]
    if run.unit != "proof" or not xs:
        return None
    return sum(xs) / len(xs) * 1e3
