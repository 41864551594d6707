"""A torch.profiler trace of one proof, and its device time by stage.

    python -m zkrollup_torch.tools.trace_prove [--circuit withdraw|tx]
        [--logdir /tmp/zkr_trace] [--device cuda]

The counterpart of tools/trace_prove.py. prove() labels its stages with
torch.profiler.record_function under the reference's jax.named_scope
names (LABELS). The tool makes the key (setup on the device for the
withdraw circuit; the (2,6) demo batch's key cached in build/keys/ for
tx), runs one proof outside the trace, then one proof under
torch.profiler (CPU, and CUDA on a card), synchronised inside the
profile, checks it with verify, and writes the Chrome trace into
--logdir (chrome://tracing or Perfetto read it).

It prints, for each label, the device time of the kernels and copies
launched inside it, their count and the largest kernel names, beside the
device's busy time (the union of every kernel and copy) and the wall.
The kernels are attributed by correlation id: each device event's launch
(its cudaLaunchKernel or copy call, same "correlation" in the trace) lies
inside the label's span on the host thread that launched it. The
profiler does not do this itself for the port's kernels: they are
launched through ctypes, under no aten op, so they carry no "External
id" and its event tree gives the label no device time; its
gpu_user_annotation span of the label (printed as "span") covers them,
but as a span, idle gaps included. On a card the profiled proof follows
a lead-in of spin-kernel launches, left out of the table: the profiler
may drop the first device events of a session (whole_window).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import common

# the stage labels of groth16/prove.py, in the order a proof enters them
# (zkrollup/groth16/prove.py's jax.named_scope names)
LABELS = ("groth16.spmv_abc", "groth16.quotient", "groth16.msm_g1",
          "groth16.msm_g2")
UNLABELLED = "(no label)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# torch.profiler (2.11, on an H100) may drop the first device events of a
# session: always its first ones, in some sessions and not in others, more
# the longer the process went without a session (tools/profiler_drops.py).
# A window on a card therefore opens with a lead-in of torch.cuda._sleep's
# spin kernel, which by_label leaves out and counts; whole_window makes
# the lead-in LEAD_GROWTH times longer, at most ATTEMPTS times, until no
# launch after it has lost its kernel.
LEAD_IN = 64
LEAD_GROWTH = 8
ATTEMPTS = 4
LEAD_NAME = "spin_kernel"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def lead_in(dev, n: int = LEAD_IN) -> None:
    """n launches of the spin kernel on a card (none on the CPU)."""
    if dev.type == "cuda":
        for _ in range(n):
            torch.cuda._sleep(1)


def launch_kept(events) -> list:
    """For each kernel launch in the trace events, in launch order
    (correlation id), whether the trace holds its kernel."""
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return [c in kernels for c in sorted(
        e["args"]["correlation"] for e in events
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
        and "Launch" in e["name"] and "correlation" in e.get("args", {}))]


def lost_launches(events, lead: int) -> int:
    """Kernel launches of a window, after its first `lead` (the lead-in),
    whose kernel the trace events lack."""
    return launch_kept(events)[lead:].count(False)


def window(dev, fn, path: str, lead: int = 0):
    """fn() under torch.profiler (CPU, and CUDA on a card) after `lead`
    lead-in launches, the device synchronised inside; its Chrome trace
    written to `path`. Returns (profiler, trace_events(path), seconds of
    fn and the synchronise, fn's result)."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        lead_in(dev, lead)
        t0 = time.perf_counter()
        out = fn()
        common.sync(dev)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return prof, trace_events(path), wall, out


def whole_window(dev, fn, path: str) -> dict:
    """window() on a card with a lead-in of LEAD_IN launches, again with
    one LEAD_GROWTH times longer while a launch after the lead-in lost its
    kernel; raises after ATTEMPTS windows. On the CPU one window, no
    lead-in. Returns {"prof", "events", "wall_s", "out", "lead" (lead-in
    launches of the last window), "lost" (launches after the lead-in that
    lost their kernel, by window)}."""
    lead = LEAD_IN if dev.type == "cuda" else 0
    lost = []
    while len(lost) < ATTEMPTS:
        prof, events, wall, out = window(dev, fn, path, lead)
        lost.append(lost_launches(events, lead))
        if not lost[-1]:
            return {"prof": prof, "events": events, "wall_s": wall,
                    "out": out, "lead": lead, "lost": lost}
        lead *= LEAD_GROWTH
    raise RuntimeError(f"the profiler lost kernels after the lead-in in "
                       f"{ATTEMPTS} windows in a row: {lost}")


def by_label(events) -> dict:
    """Device time by label from Chrome trace events (Kineto's JSON).
    Returns {label | UNLABELLED: {"us", "count", "names": Counter of
    microseconds by kernel name, "span_us"}}, under "_busy_us" the union
    of all device events and under "_lead_in" the count of lead-in
    launches recorded (left out of the rest)."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("pid"), e.get("tid"),
                    e["name"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"] in LABELS)
    launched = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = (e["ts"], e.get("pid"), e.get("tid"))
    rows = {k: {"us": 0.0, "count": 0, "names": collections.Counter(),
                "span_us": 0.0} for k in (*LABELS, UNLABELLED)}
    for e in xs:
        if e.get("cat") == "gpu_user_annotation" and e["name"] in LABELS:
            rows[e["name"]]["span_us"] += e["dur"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e) for e in xs
                 if e.get("cat") in DEVICE_CATS
                 and LEAD_NAME not in e["name"])
    rows["_lead_in"] = sum(e.get("cat") == "kernel" and LEAD_NAME in e["name"]
                           for e in xs)
    busy, end = 0.0, float("-inf")
    for a, b, e in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        at = launched.get(e.get("args", {}).get("correlation"))
        label = UNLABELLED
        if at is not None:
            # the innermost label open at the launch, on the same thread
            inside = [s for s in spans if s[0] <= at[0] <= s[1]
                      and s[2:4] == at[1:3]]
            if inside:
                label = max(inside)[4]
        row = rows[label]
        row["us"] += b - a
        row["count"] += 1
        row["names"][e["name"]] += b - a
    rows["_busy_us"] = busy
    return rows


def label_order(events) -> list:
    """The labels' host ranges in the order they opened."""
    return [e["name"] for e in sorted(
        (e for e in events if e.get("ph") == "X"
         and e.get("cat") == "user_annotation" and e["name"] in LABELS),
        key=lambda e: e["ts"])]


_EVENT = re.compile(r'\{\s*"ph":\s*"X",\s*"cat":\s*"([A-Za-z_]+)"')


def trace_events(path: str) -> list:
    """The complete events ("ph": "X") of a Chrome trace written by
    export_chrome_trace whose category by_label and label_order read,
    each parsed alone: a proof traced on the CPU records millions of aten
    ops (a gigabyte of JSON) that neither reads."""
    keep = {"user_annotation", "gpu_user_annotation", *DEVICE_CATS,
            *LAUNCH_CATS}
    with open(path) as f:
        text = f.read()
    decode = json.JSONDecoder().raw_decode
    return [decode(text, m.start())[0] for m in _EVENT.finditer(text)
            if m.group(1) in keep]


def table(rows: dict, wall_s: float, lead: int = 0) -> list:
    """Printable lines of a by_label result of a window with `lead`
    lead-in launches."""
    busy = rows["_busy_us"]
    out = [f"wall {wall_s * 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
           f"({busy / 1e6 / wall_s:.3f} of the wall); lead-in launches "
           f"kept {rows['_lead_in']} of {lead}"]
    for k, r in rows.items():
        if k.startswith("_"):
            continue
        top = ", ".join(f"{n[:48]} {t / 1e3:.3f}"
                        for n, t in r["names"].most_common(3))
        out.append(f"{k:18s} {r['us'] / 1e3:9.3f} ms device, "
                   f"{r['count']:5d} kernels and copies, span "
                   f"{r['span_us'] / 1e3:8.3f} ms; {top}")
    return out


def run(pk, r1cs, witness, public_signals, device, logdir: str,
        name: str = "prove") -> dict:
    """One warm proof, then one under torch.profiler on `device`
    (whole_window: after a lead-in on a card); raises unless the traced
    proof verifies. Writes <logdir>/trace_<name>.json and returns
    {"proof", "wall_s", "rows" (by_label), "order" (label_order), "trace"
    (its path), "lead" and "lost" (whole_window's)}."""
    from ..groth16.prove import prove
    from ..groth16.verify import verify

    dev = common.device(str(device))
    prove(pk, r1cs, witness, r=3, s=5, device=dev)
    common.sync(dev)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{name}.json")
    w = whole_window(dev, lambda: prove(pk, r1cs, witness, r=3, s=5,
                                        device=dev), path)
    if not verify(pk.vk, w["out"], public_signals):
        raise RuntimeError("the traced proof does not verify")
    return {"proof": w["out"], "wall_s": w["wall_s"],
            "rows": by_label(w["events"]), "order": label_order(w["events"]),
            "trace": path, "lead": w["lead"], "lost": w["lost"]}


def circuit(which: str, dev):
    """(pk, r1cs, witness, public signals) of the withdraw circuit (key
    made by setup on `dev`, seed b"trace", as the reference) or of the
    (2,6) demo batch (its key from build/keys/)."""
    if which == "withdraw":
        from ..groth16.setup import setup
        from ..r1cs.circuits import synthesize_withdraw
        from ..ref import eddsa
        res = synthesize_withdraw(eddsa.format_priv_key_for_babyjub(12345),
                                  777)
        pk = setup(res.r1cs, seed=b"trace", device=dev)
        return pk, res.r1cs, res.witness, res.public_signals
    prover, prep = common.demo_batch(dev)
    return (prover.ensure_keys(), prover.structure_r1cs(), prep.witness,
            prep.public_signals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--circuit", choices=("withdraw", "tx"),
                    default="withdraw")
    ap.add_argument("--logdir", default="/tmp/zkr_trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    pk, r1cs, witness, publics = circuit(args.circuit, dev)
    print(f"{args.circuit}: {pk.n_vars} variables, domain {pk.domain_size}, "
          f"on {common.device_name(dev)}", flush=True)
    out = run(pk, r1cs, witness, publics, dev, args.logdir, args.circuit)
    print(f"traced proof verified; labels in order: "
          f"{', '.join(out['order'])}; trace {out['trace']}; kernels "
          f"lost after the lead-in, by window: {out['lost']}")
    for line in table(out["rows"], out["wall_s"], out["lead"]):
        print("  " + line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
