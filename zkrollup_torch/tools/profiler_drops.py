"""How many of a window's first device events torch.profiler drops, by the
process's age and by what ran between its windows.

    python -m zkrollup_torch.tools.profiler_drops
        [--between idle|launch|sessions] [--wait 150] [--device cuda]

Two windows at the start of the process, then --wait seconds of nothing
(idle), of spin-kernel launches outside the profiler (launch) or of
back-to-back profiler sessions of one launch each (sessions), then six
windows: 64, 64, 64 after one 20 ms spin kernel, 256, 1024 and 64
lead-in launches of the spin kernel, each followed by eight launches of
an elementwise add. A line a window: the seconds since the first
window, the kernel launches, how many lost their kernel (matched by
correlation id, as trace_prove.lost_launches does), whether the lost
ones are the first launches of the window, and how many of the eight
adds kept theirs.
Run the three modes as three processes at once to compare them in one
call; trace_prove.whole_window is what the port does about the drops.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from . import common, trace_prove

WORK = 8
AFTER = ((64, False), (64, False), (64, True), (256, False), (1024, False),
         (64, False))
SPIN_20MS = 40_000_000            # torch.cuda._sleep cycles, about 20 ms


def window(dev, lead: int, spin: bool, path: str) -> dict:
    """One window: a 20 ms spin kernel first if `spin`, `lead` lead-in
    launches, WORK adds. Returns {"launches", "lost", "prefix", "work"}."""
    a = torch.ones(1 << 10, device=dev)

    def body():
        if spin and dev.type == "cuda":
            torch.cuda._sleep(SPIN_20MS)
        trace_prove.lead_in(dev, lead)
        for _ in range(WORK):
            a.add_(1)

    _, events, _, _ = trace_prove.window(dev, body, path)
    kept = trace_prove.launch_kept(events)
    lost = kept.count(False)
    return {"launches": len(kept), "lost": lost,
            "prefix": all(kept[lost:]), "work": sum(kept[len(kept) - WORK:])}


def between(dev, mode: str, seconds: float) -> int:
    """`seconds` of `mode` between windows; returns the launches or
    sessions made."""
    end, n = time.perf_counter() + seconds, 0
    if mode == "idle":
        time.sleep(max(0.0, seconds))
    while mode != "idle" and time.perf_counter() < end:
        if mode == "launch":
            trace_prove.lead_in(dev, 1000)
            n += 1000
        else:
            with torch.profiler.profile():
                trace_prove.lead_in(dev, 1)
            n += 1
        common.sync(dev)
    return n


def run(dev, mode: str = "idle", wait: float = 150.0) -> list:
    """The windows of one process: [{"age_s", "what", "launches", "lost",
    "prefix", "work"}], with the launches or sessions between them under
    "what" of the first window after the wait."""
    t0 = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.json")
        for lead, spin in ((64, False), (64, False)):
            rows.append({"age_s": time.perf_counter() - t0,
                         "what": f"lead {lead}",
                         **window(dev, lead, spin, path)})
        made = between(dev, mode, wait)
        for lead, spin in AFTER:
            rows.append({"age_s": time.perf_counter() - t0,
                         "what": f"lead {lead}"
                         + (", a 20 ms spin first" if spin else ""),
                         **window(dev, lead, spin, path)})
        rows[2]["what"] += f" (after {mode}: {made} launches or sessions)"
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--between", choices=("idle", "launch", "sessions"),
                    default="idle")
    ap.add_argument("--wait", type=float, default=150.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    print(f"torch {torch.__version__} on {common.device_name(dev)}",
          flush=True)
    for r in run(dev, args.between, args.wait):
        print(f"[{r['age_s']:7.1f} s] {args.between}: {r['what']}: "
              f"{r['launches']} launches, {r['lost']} lost (the first ones: "
              f"{r['prefix']}), work kept {r['work']} of {WORK}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
