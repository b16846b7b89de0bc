"""train.batch_wait_ms: the Trainer's wait for the prefetch thread's batch (the
span ``train.batch_wait`` around its ``next``), the mean a step over the
window of the program's spans before the profiled stretch
(``crbench/spans.py``), in ms.

Layer: train/loop.py Trainer + data/pipeline.py. Moves: train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("train.batch_wait")
