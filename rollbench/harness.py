"""One run of one cell of BENCHMARK.json, driven by data.

Everything that belongs to one configuration, traffic mix or metric is
found by its name:

- configuration <c>: the file BENCHMARK.json names for it
  (rollbench/configs/<c>.json: the circuit, its sizes, its setup seed);
- traffic mix <t>: rollbench/traffic/<t>.json, whose "entry" names the
  general entry loop that reads it (rollbench/entries/<entry>.py);
- metric <m>: rollbench/metrics/<m>.py, whose read(run) returns the
  metric's value in its unit, or None where it finds nothing to read.

A run: the look for the card, set-up (the entry loop builds the program's
objects from the seed's inputs and warms every shape the window uses),
the window of --seconds (with --trace 1 a profiled stretch of whole calls
inside it), the peak device memory, the program's state freed, the check
against the plain reference, and one JSON line. Caches stay inside the
checkout: the kernels in build/kernels/ (the program's own), the proving
keys in build/rollbench/keys/, TORCH_EXTENSIONS_DIR and TRITON_CACHE_DIR
under build/.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "zkrollup_torch"
# top-level module names that may not be loaded in a run's process: JAX,
# its libraries, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "zkrollup")


@dataclass
class Context:
    """What an entry loop is given."""
    root: str
    cell: Dict
    config: Dict
    mix: Dict
    seed: int
    device: str = "cuda"

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()


@dataclass
class Run:
    """What a metric's reader is given."""
    cell: Dict
    config: Dict
    mix: Dict
    unit: str                     # "proof" or "batch": what a call is
    setup_s: float
    window_s: float
    calls: List[Dict]             # one record a call of the window
    trace: Optional[object] = None   # trace.Summary of the traced window
    smi: Dict = field(default_factory=dict)

    def done(self) -> List[Dict]:
        """The calls that completed: a proof returned, or a batch settled."""
        key = "proof" if self.unit == "proof" else "settled_at"
        return [c for c in self.calls if c.get(key) is not None]

    def untraced(self) -> List[Dict]:
        return [c for c in self.done() if not c.get("traced")]


# -- finding things by name ----------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_parts(bench: Dict, name: str, root: str = ROOT):
    """(cell, configuration, traffic mix) of the cell `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    mix = load_json(os.path.join(root, "rollbench", "traffic",
                                 f"{cell['traffic']}.json"))
    return cell, config, mix


def entry_class(mix: Dict):
    return importlib.import_module(
        f"rollbench.entries.{mix['entry']}").Entry


def reader(name: str, root: str = ROOT):
    """read() of rollbench/metrics/<name>.py (a name may hold dots, so the
    file is loaded by its path)."""
    path = os.path.join(root, "rollbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"rollbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: end-to-end without the trace,
    per-layer with it; a metric with "workloads" only in those cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


# -- the card ----------------------------------------------------------------

def smi() -> Dict:
    """The card's clocks, power and temperature by nvidia-smi."""
    q = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": repr(e)}
    return {"line": out.strip().splitlines()[0] if out.strip() else ""}


def set_cache_dirs(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout, set
    before torch is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- a run -------------------------------------------------------------------

def measure(ctx: Context, seconds: float, trace: bool, t_start: float):
    """Set-up and window; returns (Run, the entry loop)."""
    from .trace import Tracer
    loop = entry_class(ctx.mix)(ctx)
    loop.setup()
    setup_s = time.time() - t_start
    tracer = Tracer(ctx.mix["traced_calls"]) if trace else None
    smi_before = smi() if trace and ctx.device != "cpu" else {}
    window_s = loop.run(seconds, tracer)
    smi_after = smi() if trace and ctx.device != "cpu" else {}
    run = Run(cell=ctx.cell, config=ctx.config, mix=ctx.mix, unit=loop.unit,
              setup_s=setup_s, window_s=window_s, calls=loop.records,
              trace=tracer.summary if tracer else None,
              smi={"before": smi_before, "after": smi_after})
    return run, loop


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    xs = sorted(values)
    k = max(1, -(-len(xs) * q // 100))
    return xs[int(k) - 1]


def report(bench: Dict, run: Run, trace: bool) -> Dict:
    out = {}
    for m in cell_metrics(bench, run.cell["name"], trace):
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(summary) -> Dict:
    ops = sorted(summary.op_us.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e6] for k, v in ops],
            "idle_gaps": [[label, s] for s, label in summary.gaps[:10]]}


def log(msg: str) -> None:
    print(f"rollbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of a rollbench cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = benchmark()
    cell, config, mix = cell_parts(bench, args.workload)
    set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}. No result.")
        return 3
    if importlib.util.find_spec(PROGRAM) is None:
        log(f"the program ({PROGRAM}) is not beside rollbench/. No result.")
        return 4

    ctx = Context(root=ROOT, cell=cell, config=config, mix=mix,
                  seed=args.seed, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run, loop = measure(ctx, args.seconds, bool(args.trace), t_start)
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(cell["chips"]))
    kind = torch.cuda.get_device_name(0)
    loop.release()
    torch.cuda.empty_cache()
    t0 = time.time()
    checks = loop.check()
    check_s = time.time() - t0

    found = forbidden_modules()
    if found:
        log(f"modules loaded in this process that a run may not load: "
            f"{found}. No result.")
        return 5

    metrics = report(bench, run, bool(args.trace))
    attempted = len(run.calls)
    failed = attempted - len(run.done())
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.wall_s
        result["breakdown"] = breakdown(run.trace)
        log(f"traced {run.trace.calls} whole {run.unit} calls: window "
            f"{run.trace.wall_s} s, device busy {run.trace.busy_s} s; "
            f"lead-in {run.trace.lead} launches, kernels lost by window "
            f"{run.trace.lost}; nvidia-smi (name, SM and memory clocks, "
            f"power draw, limit, temperature) before: "
            f"{run.smi['before'].get('line')}; after: "
            f"{run.smi['after'].get('line')}")
    for f in loop.failures[:5]:
        log(f"failure: {f}")
    noun = "batches" if run.unit == "batch" else f"{run.unit}s"
    log(f"setup {run.setup_s} s, window {run.window_s} s, {attempted} "
        f"calls, {failed} failed; the check took {check_s} s over "
        f"{getattr(loop, 'checked', 0)} {noun}")
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0
