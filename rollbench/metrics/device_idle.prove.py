"""device_idle.prove (%): the share of the traced window of whole proof
calls in which no kernel, copy or memset ran on the card (the union of the
device events against the window's host-clock wall)."""


def read(run):
    t = run.trace
    if t is None or run.unit != "proof" or t.wall_s <= 0:
        return None
    return 100 * (1 - t.busy_s / t.wall_s)
