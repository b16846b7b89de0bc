"""serve.mfu_pct: the whole frame's share of the card's bf16 peak, in
percent: the model FLOP of a frame from the configuration's shapes
(``crbench/yardstick.py`` ``frame_flops``: the coarse and fine forward of
every ray, enc_a over the style image, the StyleNet decodes) times the
frames completed before the profiled stretch (less a second), over that
time times 989 TFLOP/s.

Layer: the whole frame. Moves: serve_frames_per_s.
"""

from crbench.yardstick import PEAK_BF16_FLOPS


def read(d):
    if d.get("kind") != "serve" or not d["frames"]:
        return None
    return (100.0 * d["flops_per_frame"] * d["frames"]
            / (d["window_s"] * PEAK_BF16_FLOPS))
