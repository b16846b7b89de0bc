"""serve.render_kernel_roofline: K1, the fused render forward of
inference, against its bound, in percent. A frame's bound is the frozen
yardstick's (``crbench/yardstick.py`` ``render_fwd_bound`` over the
frame's rays, coarse and fine), shared evenly by its launches (a coarse
and a fine one per ``chunk`` rays); the launches of ``KERNELS`` in the
profiled stretch times that share, over their device time.

Layer: kernels: ops/fused_render.py, csrc/. Moves: serve_frames_per_s.
"""

from crbench.yardstick import Mlp, render_fwd_bound

KERNELS = ("render_fwd_wgmma_kernel", "render_fwd_kernel")


def read(d):
    t = d.get("trace")
    if d.get("kind") != "serve" or t is None:
        return None
    seconds, launches = t.time_of(KERNELS), t.count_of(KERNELS)
    if seconds <= 0:
        return None
    f = d["fields"]
    m = Mlp.of(f)
    n = d["wh"][0] * d["wh"][1]
    bf16 = f["compute_dtype"] == "bfloat16"
    frame_ms = (render_fwd_bound(m, n, f["N_samples"], bf16)[0]
                + render_fwd_bound(m, n, f["N_samples"] + f["N_importance"],
                                   bf16)[0])
    per_launch = frame_ms / (2 * -(-n // f["chunk"]))
    return 100.0 * per_launch * 1e-3 * launches / seconds
