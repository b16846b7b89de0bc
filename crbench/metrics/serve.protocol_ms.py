"""serve.protocol_ms: the self time of the span ``serve.request``, one request
line from its JSON parse to the reply's flush less the lock wait, the render
and the encode: JSON parse and dump, the request's checks, the socket write;
the mean over the window of the program's spans before the profiled stretch
(``crbench/spans.py``), in ms.

Layer: apps/serve.py RenderService. Moves: serve_p95_ms.
"""

from crbench.spans import window


def read(d):
    w = window(d, "serve")
    return None if w is None else w.mean_ms("serve.request", own=True)
