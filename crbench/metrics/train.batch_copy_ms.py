"""train.batch_copy_ms: the batch's copy to the device (the span
``train.batch_copy``), the mean a step over the window of the program's
spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: train/loop.py Trainer + data/pipeline.py. Moves: train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("train.batch_copy")
