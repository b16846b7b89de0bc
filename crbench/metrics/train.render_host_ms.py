"""train.render_host_ms: host time of the training renderer: the span
``system.render`` around ``render_rays_train`` (sampling, the sort, the
fused kernels' host wrappers), the mean a step over the window of the
program's spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: render/renderer.py + ops/fused_render.py wrappers. Moves:
train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("system.render")
