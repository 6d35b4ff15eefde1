"""What the port's own recorder (``alignnet3d_tpu_torch.tracing``) holds,
for the readers of its spans and counters.

The program records only while a ``torch.profiler`` session runs, and a
benchmark run starts one only for its traced window: the recorder holds
that window alone. A request is one closed ``api.align`` span, a training
step one closed ``trainer.train_step``. A checkout whose program keeps no
recorder, or a window in which a span or counter never closed, reads as
nothing (None).
"""

from __future__ import annotations


def _snapshot() -> dict:
    try:
        from alignnet3d_tpu_torch import tracing
    except ImportError:
        return {}
    return tracing.snapshot()


def ms_per(name: str, field: str, per: str):
    """Milliseconds of span ``name``'s ``field`` (``total_s`` or
    ``self_s``) summed over the window, per closed ``per`` span."""
    spans = _snapshot().get("spans", {})
    if name not in spans or not spans.get(per, {}).get("count"):
        return None
    return spans[name][field] / spans[per]["count"] * 1e3


def percent(part: str, whole: str):
    """100 x counter ``part`` / counter ``whole``."""
    counters = _snapshot().get("counters", {})
    if part not in counters or not counters.get(whole):
        return None
    return 100.0 * counters[part] / counters[whole]
