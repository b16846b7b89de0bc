"""train.mfu_pct: the whole step's share of the card's bf16 peak, in
percent: the model FLOP of a step from the configuration's shapes alone
(``crbench/yardstick.py`` ``step_flops``: the MLP products of both passes
three times, and the convolutions of enc_a, enc_cont, CGNet and StyleNet
forward and backward; no recompute) times the window's steps before the
profiled stretch, over their wall time times 989 TFLOP/s.

Layer: the whole step. Moves: train_rays_per_s.
"""

from crbench.yardstick import PEAK_BF16_FLOPS


def read(d):
    if d.get("kind") != "train" or not d.get("pre_steps"):
        return None
    return (100.0 * d["flops_per_step"] * d["pre_steps"]
            / (d["pre_s"] * PEAK_BF16_FLOPS))
