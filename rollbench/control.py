"""The check's two readings on the card, for setting and keeping its limits:
the program's and the control's, on many seeds in one process.

    python3 rollbench/control.py --workload <name> --seeds 1,2,3
        [--seconds 5]

For each seed: the cell's set-up and a short window at its own load, then
the check as a run makes it (the program's reading) and again with the
reference, quotient left out (prove cells) or the last batch's credits
left out (the operator cell), in the program's place (the control's
reading). One JSON line a seed, then a summary; the benchmark's own runs
never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from rollbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    cell, config, mix = harness.cell_parts(bench, args.workload)
    harness.set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(root=ROOT, cell=cell, config=config, mix=mix,
                              seed=seed)
        t0 = time.time()
        run, loop = harness.measure(ctx, args.seconds, False, t0)
        loop.release()
        program = loop.check()
        control = loop.check(control=True)
        line = {"seed": seed, "calls": len(run.calls),
                "checked": getattr(loop, "checked", 0),
                "failed": len(run.calls) - len(run.done()),
                "program": {n: v for n, v, _ in program},
                "control": {n: v for n, v, _ in control}}
        print(json.dumps(line), flush=True)
        for side in ("program", "control"):
            for n, v in line[side].items():
                key = f"{side}.{n}"
                worst[key] = (max if side == "program" else min)(
                    worst.get(key, v), v)
    print(json.dumps({"workload": args.workload,
                      "program_highest": {k[8:]: v for k, v in worst.items()
                                          if k.startswith("program.")},
                      "control_lowest": {k[8:]: v for k, v in worst.items()
                                         if k.startswith("control.")},
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
