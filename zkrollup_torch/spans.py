"""Spans: named stretches of the program's work on the host's clock.

    with span("groth16.encode"):
        ...

records a Span: its name, its trace id, its own id, its parent's id, its
start and end in time.perf_counter_ns(), and whether a torch.profiler
session was recording. A span's parent is the span open on its thread
when it opened. Its trace id, unless given, is its parent's, or that of
the trace() open on its thread; the span may also be given one before it
closes (span.trace = ...). The spans of one proof or one batch share a
trace id: TxProver.prove_prepared and WithdrawProver.prove_withdraw open
a trace() for each proof, which joins the caller's trace where one is
open, and BatchDaemon.run_pipeline opens one for each batch under the
batch's first queue index.

Finished spans go into one bounded ring of this process, read by
finished(). The witness worker's spans, sent back with its result, are
filed here by add(): time.perf_counter_ns() is CLOCK_MONOTONIC on Linux,
one clock for every process on the host, so they lie on this process's
timeline as they are.

While a torch.profiler session records on the span's thread, the span
also enters torch.profiler.record_function(name): the device trace then
holds it on the profiler's own clock, and the device's work and idle
stretches can be put under the program's names; a span made with
label=False never does, so that the device work launched inside it stays
under its parent's label (the MSM's window groups, under
groth16.msm_g1 and groth16.msm_g2). Otherwise a span costs
two clock reads, two looks for a profiler and an append. This module
never imports torch, and looks for it in sys.modules, so that the
witness worker stays torch-free (witness/batch.py).
"""

from __future__ import annotations

import collections
import itertools
import sys
import threading
import time
from typing import Hashable, Iterable, List, Optional

# the spans kept: an operator settling a batch a second finishes about 20
# a batch, so the ring holds its last 3.6 hours
RING = 1 << 18

_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_done = 0                     # spans ever put into the ring
_ids = itertools.count(1)
_traces = itertools.count(1)       # new trace ids: "t1", "t2", ...
_local = threading.local()


def _stack() -> list:
    """The spans and traces open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class Span:
    """One named stretch of work, a context manager: span(name, trace,
    label); label=False keeps it out of the profiler's labels."""

    __slots__ = ("name", "trace", "id", "parent", "start_ns", "end_ns",
                 "profiled", "labels", "_label")

    def __init__(self, name: str, trace: Optional[Hashable] = None,
                 label: bool = True):
        self.name = name
        self.trace = trace
        self.labels = label
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0
        self.profiled = False
        self._label = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
            if self.trace is None:
                self.trace = stack[-1].trace
        if self.labels and _profiling():
            from torch.profiler import record_function
            self._label = record_function(self.name)
            self._label.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _done
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        self.profiled = self._label is not None or _profiling()
        if self._label is not None:
            self._label.__exit__(None, None, None)
            self._label = None
        with _lock:
            _ring.append(self)
            _done += 1

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace!r}, id={self.id}, "
                f"parent={self.parent}, {self.seconds * 1e3:.3f} ms"
                f"{', profiled' if self.profiled else ''})")


# span(name, trace=None, label=True): a span of trace `trace` (by default
# its parent's, or the trace open on this thread), recorded when its
# `with` ends
span = Span


class Trace:
    """The trace id of the spans opened inside it on this thread (see
    trace()); spans() gives those of its id finished since it opened."""

    __slots__ = ("trace", "id", "mark")

    def __init__(self, trace: Hashable):
        self.trace = trace
        self.id = None                # a trace is no span: no parent id
        self.mark = 0

    def __enter__(self) -> "Trace":
        _stack().append(self)
        self.mark = _done
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()

    def spans(self) -> List["Span"]:
        """The spans of this trace id finished in this process since the
        trace opened (its own and those add() filed), oldest first."""
        with _lock:
            n = min(_done - self.mark, len(_ring))
            recent = list(itertools.islice(reversed(_ring), n))
        return [s for s in reversed(recent) if s.trace == self.trace]


def trace(trace_id: Optional[Hashable] = None) -> Trace:
    """A trace for the spans opened inside its `with` on this thread:
    `trace_id`, else the trace of the span or trace open on this thread,
    else a new one."""
    if trace_id is None:
        stack = _stack()
        trace_id = stack[-1].trace if stack else None
    return Trace(f"t{next(_traces)}" if trace_id is None else trace_id)


def add(spans: Iterable[Span], trace: Hashable) -> None:
    """Files spans recorded in another process under `trace`, with ids of
    this process (the links between them kept)."""
    spans = list(spans)
    ids = {s.id: next(_ids) for s in spans}
    for s in spans:
        s.id, s.parent, s.trace = ids[s.id], ids.get(s.parent), trace
    global _done
    with _lock:
        _ring.extend(spans)
        _done += len(spans)


def finished() -> List[Span]:
    """A copy of the ring: the spans finished in this process (and filed
    by add()), oldest first, at most RING of them."""
    with _lock:
        return list(_ring)
