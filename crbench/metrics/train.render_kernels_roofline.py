"""train.render_kernels_roofline: the fused render kernels of the
stash route against their bound, in percent. The bound is the frozen
yardstick's (``crbench/yardstick.py`` ``train_pass_bounds``: the stash
forward, K2's chain and K2's weight gradient of the coarse and the fine
pass, each the larger of operations over the bf16 peak and bytes over the
memory rate) times the steps of the profiled stretch; the time is the
profiler's device time of the kernels named in ``KERNELS``.

Layer: kernels: ops/fused_render.py, csrc/. Moves: train_rays_per_s.
"""

from crbench.yardstick import Mlp, train_pass_bounds

KERNELS = ("render_fwd_wgmma_kernel", "render_fwd_kernel",
           "render_bwd_chain_wgmma_kernel", "render_bwd_chain_kernel",
           "wgrad_wgmma_kernel", "wgrad_bf16_kernel", "wgrad_f32_kernel",
           "reduce_partials_kernel")


def read(d):
    t = d.get("trace")
    if d.get("kind") != "train" or t is None or not d["stretch_steps"]:
        return None
    seconds = t.time_of(KERNELS)
    if seconds <= 0:
        return None
    f = d["fields"]
    m = Mlp.of(f)
    n = f["grids_per_step"] * f["batch_size"]
    bf16 = f["compute_dtype"] == "bfloat16"
    ms = sum(b for s in (f["N_samples"], f["N_samples"] + f["N_importance"])
             for b, _ in train_pass_bounds(m, n, s, bf16).values())
    return 100.0 * ms * 1e-3 * d["stretch_steps"] / seconds
