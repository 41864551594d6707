"""quotient_roofline (%): the least device time of the proof's quotient
transforms (rollbench/workmodel.py, from the configuration's domain) over
the device time of the kernels and copies launched under the program's
groth16.quotient label, a proof, in the traced window."""

from rollbench import workmodel

LABEL = "groth16.quotient"


def read(run):
    t = run.trace
    if t is None or run.unit != "proof" or not t.label_us.get(LABEL):
        return None
    per_proof = t.label_us[LABEL] / 1e6 / t.calls
    return 100 * workmodel.quotient_seconds(run.config) / per_proof
