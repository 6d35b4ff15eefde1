"""Spans and counters of the port's host paths, live only while a
``torch.profiler`` session runs.

    from alignnet3d_tpu_torch import tracing

    with tracing.span("api.resample"):
        ...
    tracing.count("serving.padded_rows", pad)
    tracing.snapshot()  # {"spans": {name: {count, total_s, self_s}},
                        #  "counters": {name: n}, "records": [Record]}

With no profiler session running, ``span`` returns the shared ``NO_SPAN``
after one check of ``torch.autograd.profiler._is_profiler_enabled`` (a
Python flag every thread sees; the C-side check reads False in a thread
the profiler was not started in, such as the prefetch producer's): it
enters no ``record_function``, reads no clock and allocates nothing, and
``count`` does nothing.

While a session runs, a span is also a ``record_function`` range, so it
sits on the device trace's clock in any profile (an operator's, the
trainer's ``tpu.profile``, a benchmark's traced window) and names the host
work around the device's idle gaps. It stamps its start and end with
``time.perf_counter_ns``, keeps a per-thread stack so that each record
holds its parent and the root shared by every span of one request or step,
and on exit appends its record to a bounded in-memory deque and adds to
per-name aggregates: count, total time, and self time (the duration less
its direct children's). A span never synchronises the device, so a span
around an asynchronous launch times its dispatch. The profiler's own trace
is the export: this module writes no file.

Keep spans out of what gets traced or exported (the forward
``serving.build_inference_fn`` returns, ``models/``, the custom ops,
anything ``export.py`` traces): a ``record_function`` there would enter
the exported graph.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

RECORDS = 65536  # span records kept, newest last
_clock = time.perf_counter_ns


class Record(NamedTuple):
    """One closed span: ids are unique in the process; ``parent`` is None
    for a root, whose ``root`` is its own id."""
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int


class _NoSpan:
    """The context a span site gets while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """Span records and per-name aggregates, merged across threads under a
    lock that only live spans and counters take."""

    def __init__(self, maxlen: int = RECORDS):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._records: collections.deque = collections.deque(maxlen=maxlen)
        self._spans: dict = {}     # name -> [count, total ns, self ns]
        self._counters: dict = {}  # name -> n

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, record: Record, self_ns: int):
        with self._lock:
            self._records.append(record)
            agg = self._spans.get(record.name)
            if agg is None:
                agg = self._spans[record.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += record.end_ns - record.start_ns
            agg[2] += self_ns

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "spans": {name: {"count": c, "total_s": t / 1e9,
                                 "self_s": s / 1e9}
                          for name, (c, t, s) in self._spans.items()},
                "counters": dict(self._counters),
                "records": list(self._records)}

    def reset(self):
        with self._lock:
            self._records.clear()
            self._spans.clear()
            self._counters.clear()


class _Span:
    __slots__ = ("_recorder", "name", "_range", "_parent", "id", "root",
                 "_child_ns", "_start")

    def __init__(self, recorder: Recorder, name: str):
        self._recorder = recorder
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        stack = self._recorder._stack()
        self._parent = stack[-1] if stack else None
        self.id = next(self._recorder._ids)
        self.root = self._parent.root if self._parent is not None else self.id
        self._child_ns = 0
        stack.append(self)
        self._start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self._recorder._stack().pop()
        duration = end - self._start
        parent = self._parent
        if parent is not None:
            parent._child_ns += duration
        self._recorder._close(
            Record(self.name, self.id, parent.id if parent else None,
                   self.root, threading.get_ident(), self._start, end),
            duration - self._child_ns)
        self._range.__exit__(*exc)
        return False


_RECORDER = Recorder()


def span(name: str):
    """A context naming the host work inside it (see the module doc)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(_RECORDER, name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while a profiler session runs."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.count(name, n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}, "records": [Record]}`` of what was recorded since the last
    ``reset``."""
    return _RECORDER.snapshot()


def reset():
    """Forget every record, aggregate and counter."""
    _RECORDER.reset()
