"""serve.between_renders_ms: the mean of max(0, next start - this end) over
consecutive ``serve.render`` spans of the window of the program's spans
before the profiled stretch (``crbench/spans.py``), from every handler
thread, in ms. A render ends with its fetch, so this is the device's idle
time between two frames.

Layer: apps/serve.py RenderService. Moves: serve_frames_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "serve")
    return None if w is None else w.between_ms("serve.render")
