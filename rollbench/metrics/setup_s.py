"""setup_s (s): from the run's first statement to the window's first call:
imports, CUDA, kernels built or loaded, the proving key made or loaded
(the R1CS digest with it), the traffic's inputs, the warm-up calls."""


def read(run):
    return run.setup_s
