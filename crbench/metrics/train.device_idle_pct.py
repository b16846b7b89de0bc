"""train.device_idle_pct: the share of the profiled stretch of training
steps in which no device operation ran, in percent, from the profiler's
trace. The profiler's own host work is inside the stretch, so this reads
higher than an unprofiled step's idle share.

Layer: device. Moves: train_rays_per_s.
"""


def read(d):
    t = d.get("trace")
    if d.get("kind") != "train" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
