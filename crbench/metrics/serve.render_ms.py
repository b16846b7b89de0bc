"""serve.render_ms: the mean over the window's
replies before the profiled stretch of the reply's
``ms``: the Renderer's wall clock from the camera in to the uint8 frame
on the host.

Layer: render/inference.py Renderer. Moves: serve_frames_per_s.
"""


def read(d):
    if d.get("kind") != "serve" or not d["render_ms"]:
        return None
    return sum(d["render_ms"]) / len(d["render_ms"])
