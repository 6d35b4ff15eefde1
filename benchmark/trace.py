"""Reading a ``torch.profiler`` window: device-busy time, kernel time by
name, and the idle gaps labelled by what the host was doing.

The busy-time arithmetic is that of the port's smoke script's trace reader
(the union of every kernel, memcpy and memset interval, so that overlapping
streams count once), here over the profiler's event list instead of a
Chrome trace file. A ``record_function`` range also leaves a device-side
copy (a GPU user annotation) over its whole span: such events are left out
by their type, whatever their name, so that spans the program or the
benchmark adds never count as device work.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

# the benchmark's own host spans, named in every traced window
SPANS = ("align", "train_step", "prefetch_wait")
SHORT_NS = 20_000  # idle gaps shorter than this are not labelled by op
LOOKBACK = 4096    # host ops searched back for the one covering a gap


@dataclass
class Window:
    """What one profiled window holds."""
    window_s: float
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)   # device op name -> s
    idle_gaps: list = field(default_factory=list)  # [(label, s)]
    spans: dict = field(default_factory=dict)      # span name -> [s]


def _ns(e, which):
    return getattr(e, f"{which}_ns")()


def read(prof, window_s: float) -> Window:
    """Reduce a finished profile to a ``Window``."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        kind = str(e.device_type())
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if kind.endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((start, start + dur, e.name()))
        elif kind.endswith("CPU"):
            host.append((start, start + dur, e.name()))
    out = Window(window_s=window_s)
    for a, b, name in host:
        if name in SPANS:
            out.spans.setdefault(name, []).append((b - a) / 1e9)
    if not device:
        return out
    for a, b, name in device:
        out.kernel_s[name] = out.kernel_s.get(name, 0.0) + (b - a) / 1e9
    busy, end, gaps = 0, None, []
    for a, b, _ in sorted(device):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    out.busy_s = busy / 1e9
    out.idle_gaps = _label(gaps, host)
    return out


def _label(gaps, host):
    """Each idle gap's label: the benchmark span and the innermost host op
    running at its middle ('<span>/<op>'; gaps under ``SHORT_NS`` are
    pooled as '<span>/short'); the gap seconds summed by label, longest
    first."""
    spans = sorted((a, b, n) for a, b, n in host if n in SPANS)
    ops = sorted((a, b, n) for a, b, n in host if n not in SPANS)
    totals: dict = {}
    op_starts = [a for a, _, _ in ops]
    span_starts = [a for a, _, _ in spans]

    def covering(starts, items, t, depth):
        best = None
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - depth), -1):
            s, e, n = items[j]
            if s <= t < e and (best is None or s > best[0]):
                best = (s, n)
        return best[1] if best else "-"

    for a, b in gaps:
        mid = (a + b) // 2
        span = covering(span_starts, spans, mid, 4)
        op = (covering(op_starts, ops, mid, LOOKBACK) if b - a >= SHORT_NS
              else "short")
        key = f"{span}/{op}"
        totals[key] = totals.get(key, 0.0) + (b - a) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def profiled(device: str):
    """A torch.profiler window over the block (host activity, and the
    card's on a CUDA device); yields a holder whose ``window`` is set on
    exit."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import sync

    holder = type("Holder", (), {"window": None})()
    cuda = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield holder
        sync(device)
        window_s = time.perf_counter() - t0
    holder.window = read(prof, window_s)
