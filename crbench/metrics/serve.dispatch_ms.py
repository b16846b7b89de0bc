"""serve.dispatch_ms: the Renderer's enqueue of a frame on the host (the span
``render.dispatch``: rays, uv, the forward's launches); the render's ``ms``
less this is the wait on the device and the fetch. The mean a request over
the window of the program's spans before the profiled stretch
(``crbench/spans.py``), in ms.

Layer: render/inference.py Renderer. Moves: serve_frames_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "serve")
    return None if w is None else w.mean_ms("render.dispatch")
