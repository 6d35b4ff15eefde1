"""Pairs aligned by every completed offline request of the measured window
over the window's wall time (host clock): the host-bound request path's
rate, too unsteady from run to run to hold end to end.
"""


def read(reading):
    pairs, window_s = reading.get("pairs"), reading.get("window_s")
    if not pairs or not window_s:
        return None
    return pairs / window_s
