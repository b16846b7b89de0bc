"""serve.lock_wait_ms: the wait for the service's render lock (the span
``serve.lock_wait``), the mean a request over the window of the program's
spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: apps/serve.py RenderService. Moves: serve_p95_ms.
"""

from crbench.spans import window


def read(d):
    w = window(d, "serve")
    return None if w is None else w.mean_ms("serve.lock_wait")
