"""The traced run's device trace: a window of whole calls under
torch.profiler, read from the profiler's Chrome trace.

A frozen copy of the program's tools/trace_prove.py method (commit
f14ca18), kept here so that later changes to the program's tools do not
move the yardstick:

- attribution by correlation id: each device event (kernel, copy, memset)
  belongs to the innermost host label (a torch.profiler.record_function
  span: the program's groth16.* stage labels, the benchmark's rollbench.*
  spans) open on the launching thread when its launch call ran. The port
  launches its kernels through ctypes, under no aten op, so the
  profiler's own event tree gives them no label;
- whole windows: torch.profiler may drop the first device events it
  records after it starts, so a window opens with a lead-in of spin-kernel
  launches, left out of every sum; where a kernel launched after the lead-in is missing
  from the trace, the window is made again on the next calls with a
  LEAD_GROWTH times longer lead-in, at most ATTEMPTS times.

The trace is exported to a file in the run's TMPDIR, parsed, and the file
deleted at once; nothing of it stays on disk.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

LEAD_IN = 64
LEAD_GROWTH = 8
ATTEMPTS = 4
LEAD_NAME = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LABEL_CAT = "user_annotation"
NO_LABEL = "(no label)"
WINDOW_SPAN = "rollbench.window"

_EVENT = re.compile(r'\{\s*"ph":\s*"X",\s*"cat":\s*"([A-Za-z_]+)"')


def parse_chrome(text: str) -> list:
    """The complete events ("ph": "X") of an exported Chrome trace whose
    category this module reads, each parsed alone."""
    keep = {LABEL_CAT, *DEVICE_CATS, *LAUNCH_CATS}
    decode = json.JSONDecoder().raw_decode
    return [decode(text, m.start())[0] for m in _EVENT.finditer(text)
            if m.group(1) in keep]


def launch_kept(events) -> list:
    """For each kernel launch, in launch order (correlation id), whether
    the trace holds its kernel."""
    kernels = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "kernel"}
    return [c in kernels for c in sorted(
        e["args"]["correlation"] for e in events
        if e.get("cat") in LAUNCH_CATS and "Launch" in e["name"]
        and "correlation" in e.get("args", {}))]


def lost_launches(events, lead: int) -> int:
    """Kernel launches after the first `lead` whose kernel is missing."""
    return launch_kept(events)[lead:].count(False)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    while "<" in name:
        i = name.find("<")
        depth, j = 0, i
        for j in range(i, len(name)):
            depth += {"<": 1, ">": -1}.get(name[j], 0)
            if depth == 0:
                break
        name = name[:i] + name[j + 1:]
    name = name.replace("void ", "").strip()
    return name[-60:]


@dataclass
class Summary:
    """What one whole traced window holds."""
    calls: int
    wall_s: float                  # host clock, after the lead-in
    busy_s: float                  # union of the device events
    label_us: Dict[str, float]     # device us by innermost label
    op_us: Dict[str, float]        # device us by "label:kernel"
    gaps: List[tuple]              # idle (seconds, host label), longest first
    lead: int
    lost: List[int] = field(default_factory=list)


def summarize(events, calls: int, wall_s: float, lead: int) -> Summary:
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("pid"), e.get("tid"),
                    e["name"]) for e in xs if e.get("cat") == LABEL_CAT)
    launched = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = (e["ts"], e.get("pid"), e.get("tid"))
    win = [s for s in spans if s[4] == WINDOW_SPAN]
    w0, w1 = (win[0][0], win[-1][1]) if win else (float("-inf"),
                                                  float("inf"))
    dev = sorted((e["ts"], e["ts"] + e["dur"], e) for e in xs
                 if e.get("cat") in DEVICE_CATS
                 and LEAD_NAME not in e["name"] and w0 <= e["ts"] <= w1)

    def label_at(t, where=None):
        inside = [s for s in spans if s[0] <= t <= s[1]
                  and (where is None or s[2:4] == where)]
        return max(inside)[4] if inside else NO_LABEL

    label_us = collections.Counter()
    op_us = collections.Counter()
    busy, end = 0.0, None
    idle = []
    for a, b, e in dev:
        if end is not None and a > end:
            idle.append((end, a))
        busy += b - a if end is None else max(0.0, b - max(a, end))
        end = b if end is None else max(end, b)
        at = launched.get(e.get("args", {}).get("correlation"))
        label = NO_LABEL if at is None else label_at(at[0], at[1:3])
        label_us[label] += b - a
        op_us[f"{label}:{short_name(e['name'])}"] += b - a
    if dev and win:
        # the idle stretches before the first and after the last event
        idle += [(w0, dev[0][0]), (end, w1)]
    # each idle stretch cut where the innermost host label changes
    edges = sorted({x for s in spans for x in s[:2]})
    gaps = []
    for g0, g1 in idle:
        cuts = [g0] + [x for x in edges if g0 < x < g1] + [g1]
        run_label, run_start = None, g0
        for a, b in zip(cuts, cuts[1:]):
            label = label_at((a + b) / 2)
            if label != run_label:
                if run_label is not None and a > run_start:
                    gaps.append(((a - run_start) / 1e6, run_label))
                run_label, run_start = label, a
        if g1 > run_start:
            gaps.append(((g1 - run_start) / 1e6, run_label))
    gaps.sort(key=lambda g: -g[0])
    return Summary(calls=calls, wall_s=wall_s, busy_s=busy / 1e6,
                   label_us=dict(label_us), op_us=dict(op_us), gaps=gaps,
                   lead=lead)


class Tracer:
    """Profiles `calls` whole consecutive calls of a window, from call
    `first`. The caller starts the profiler before its window (open()),
    so that starting it stalls no call, and tells the tracer when
    call i starts and finishes (started(i), finished(i), on one thread).
    When the trace lost a kernel after the lead-in, the profiler starts
    again at once with a LEAD_GROWTH times longer lead-in, and the window is made
    again SKIP calls later. `summary` holds the result once a window was
    whole."""

    SKIP = 2

    def __init__(self, calls: int, first: int = 2):
        self.calls = calls
        self.next = first
        self.lead = LEAD_IN
        self.lost: List[int] = []
        self.summary: Optional[Summary] = None
        self._prof = None
        self._span = None
        self._first = None
        self._t0 = 0.0

    @property
    def busy(self) -> bool:
        """Whether a window is open or still to come."""
        return self.summary is None

    def open(self) -> None:
        """The profiler started (CPU and CUDA activities), and its lead-in."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        for _ in range(self.lead):
            torch.cuda._sleep(1)

    def close(self) -> None:
        """Stops the profiler where no whole window closed."""
        if self._prof is not None:
            if self._span is not None:
                self._span.__exit__(None, None, None)
            self._prof.stop()
            self._prof = self._span = None

    def started(self, i: int) -> bool:
        """Opens the window at its first call; whether call i runs under
        the profiler."""
        if self._prof is not None and self._span is None \
                and self.summary is None and i >= self.next:
            from torch.profiler import record_function
            self._first = i
            self._span = record_function(WINDOW_SPAN)
            self._span.__enter__()
            self._t0 = time.perf_counter()
        return self._prof is not None

    def finished(self, i: int) -> None:
        if self._span is None or i < self._first + self.calls - 1:
            return
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = parse_chrome(f.read())
        finally:
            os.unlink(path)
        self._prof = self._span = None
        self.lost.append(lost_launches(events, self.lead))
        if not self.lost[-1]:
            self.summary = summarize(events, self.calls, wall, self.lead)
            self.summary.lost = list(self.lost)
            return
        if len(self.lost) >= ATTEMPTS:
            raise RuntimeError(f"the profiler lost kernels after the lead-in "
                               f"in {ATTEMPTS} windows in a row: {self.lost}")
        self.lead *= LEAD_GROWTH
        self.next = i + 1 + self.SKIP
        self.open()
