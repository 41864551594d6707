"""device_idle.operator (%): the share of the traced window of whole
settled batches (from a batch's prove to the state's update of the last)
in which no kernel, copy or memset ran on the card."""


def read(run):
    t = run.trace
    if t is None or run.unit != "batch" or t.wall_s <= 0:
        return None
    return 100 * (1 - t.busy_s / t.wall_s)
