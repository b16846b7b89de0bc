"""serve.device_idle_pct: the share of the profiled stretch of the
serving window in which no device operation ran, in percent, from the
profiler's trace.

Layer: device. Moves: serve_frames_per_s.
"""


def read(d):
    t = d.get("trace")
    if d.get("kind") != "serve" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
