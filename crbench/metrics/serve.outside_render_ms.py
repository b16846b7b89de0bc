"""serve.outside_render_ms: the mean over the window's
replies before the profiled stretch of the
client's latency minus the reply's ``ms`` (the render and fetch the
service times itself), in ms: the lock wait, the PNG encode, base64,
JSON and TCP.

Layer: apps/serve.py RenderService. Moves: serve_p95_ms.
"""


def read(d):
    if d.get("kind") != "serve" or not d["outside_ms"]:
        return None
    return sum(d["outside_ms"]) / len(d["outside_ms"])
