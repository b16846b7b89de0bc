"""train.update_host_ms: host time from the chunks' backward to the step's end
(the span ``train.update``: the learning rate, Adam's step, the embedding
cache, CGNet's running statistics), the mean a step over the window of the
program's spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: train/step.py make_train_step. Moves: train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("train.update")
