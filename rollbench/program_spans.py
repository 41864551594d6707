"""What the per-layer metrics of source program_span read: the program's
span recorder (zkrollup_torch.spans) in the run's own process, at report
time.

The spans of one proof or one batch share a trace id. A metric is the
median, over the traces none of whose spans ran under a profiler session
(the traced window's are left out), of the milliseconds of the named
spans summed within each trace. The ring also holds the set-up's
warm-up calls, which a reader cannot pick out: the median keeps them
from moving the value. None where the program has no recorder or no
such trace holds one of the spans.
"""

from __future__ import annotations

import statistics
from typing import Iterable, Optional


def finished() -> Optional[list]:
    """The program's finished spans, or None where it has no recorder."""
    try:
        from zkrollup_torch import spans
    except ImportError:
        return None
    return spans.finished()


def median_ms(names: Iterable[str], found=None) -> Optional[float]:
    """The median over untraced proofs or batches of the summed ms of the
    spans named `names` in each (found: the spans, by default the
    program's)."""
    found = finished() if found is None else found
    if not found:
        return None
    names = set(names)
    by_trace = {}
    for s in found:
        if s.trace is not None:
            by_trace.setdefault(s.trace, []).append(s)
    values = []
    for group in by_trace.values():
        if any(s.profiled for s in group):
            continue
        hit = [s for s in group if s.name in names]
        if hit:
            values.append(sum(s.end_ns - s.start_ns for s in hit) / 1e6)
    return statistics.median(values) if values else None
