"""train.backward_host_ms: host time of autograd's backward over the step (the
span ``train.backward``), the mean a step over the window of the program's
spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: autograd over the step. Moves: train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("train.backward")
