"""train.nets_host_ms: host time of the forward outside the renderer: the self
time of the span ``train.forward`` (enc_a, CGNet, the StyleNet decodes,
enc_cont, the loss and PSNR), the mean a step over the window of the
program's spans before the profiled stretch (``crbench/spans.py``), in ms.

Layer: render/system.py image nets + train/losses.py. Moves: train_rays_per_s.
"""

from crbench.spans import window


def read(d):
    w = window(d, "train")
    return None if w is None else w.mean_ms("train.forward", own=True)
