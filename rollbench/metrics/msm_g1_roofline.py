"""msm_g1_roofline (%): the least device time of the proof's G1 MSMs
(rollbench/workmodel.py, from the configuration's sizes) over the device
time of the kernels and copies launched under the program's
groth16.msm_g1 label, a proof, in the traced window."""

from rollbench import workmodel

LABEL = "groth16.msm_g1"


def read(run):
    t = run.trace
    if t is None or run.unit != "proof" or not t.label_us.get(LABEL):
        return None
    per_proof = t.label_us[LABEL] / 1e6 / t.calls
    return 100 * workmodel.msm_seconds(run.config, "g1") / per_proof
