"""train.launches_per_step: device operations (kernels, copies, fills)
in the profiled stretch, divided by the steps it holds. Read from the
profiler's trace.

Layer: train/step.py make_train_step. Moves: train_rays_per_s.
"""


def read(d):
    t = d.get("trace")
    if d.get("kind") != "train" or t is None or not d["stretch_steps"]:
        return None
    return t.n_device_events / d["stretch_steps"]
