"""train.outside_step_ms: host time a training step spends outside the
step function, the mean over the window's steps before the profiled
stretch (its hooks slow the host to the run's end), in ms. Read from the
benchmark's span around each call of the Trainer's ``step_fn``: the time
from one call's return to the next call, i.e. the wait for the prefetch
thread's batch and its copy to the device.

Layer: train/loop.py Trainer + data/pipeline.py. Moves: train_rays_per_s.
"""


def read(d):
    if d.get("kind") != "train" or not d["outside_ms"]:
        return None
    return sum(d["outside_ms"]) / len(d["outside_ms"])
