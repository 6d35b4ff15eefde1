"""The arithmetic of the per-layer readers.

``reading`` is the dict a driver fills: ``trace`` (``trace.Window`` of the
profiled window), ``work`` ({kernel: [count args]} of the calls launched in
it), ``launches`` ({kernel: launches the port's counters saw in it}),
``flops`` (the model's dot-product FLOPs of the work completed in it),
``latencies_s`` (requests of the measured window), ``pairs`` and
``window_s`` (pairs it completed, its wall time), ``wait_s`` (host waits
on the batch iterator in the measured window).
"""

from __future__ import annotations

import importlib
import re

import numpy as np

from benchmark.counts import peaks


def idle_pct(reading):
    w = reading.get("trace")
    if w is None or w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def mfu(reading):
    w = reading.get("trace")
    if w is None or not reading.get("flops") or w.busy_s <= 0:
        return None
    return 100.0 * reading["flops"] / w.window_s / peaks.TF32_FLOPS


def kernel_seconds(window, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(s for name, s in window.kernel_s.items() if rx.search(name))


def roofline(reading, kernel: str):
    """The least time of the kernel's counted work in the traced window
    over the time its device operations took there, in %; None when the
    window holds no launch of it or the port's counter disagrees with the
    calls counted."""
    w = reading.get("trace")
    calls = reading.get("work", {}).get(kernel)
    if w is None or not calls:
        return None
    counts = importlib.import_module(f"benchmark.counts.{kernel}")
    per_call = getattr(counts, "LAUNCHES_PER_CALL", 1)
    if reading.get("launches", {}).get(kernel) != per_call * len(calls):
        return None
    seconds = kernel_seconds(w, counts.KERNELS)
    if seconds <= 0:
        return None
    work = peaks.add(counts.count(*args) for args in calls)
    return 100.0 * peaks.least_seconds(work) / seconds


def median_ms(values):
    return float(np.median(values)) * 1e3 if values else None


def mean_ms(values):
    return float(np.mean(values)) * 1e3 if values else None
