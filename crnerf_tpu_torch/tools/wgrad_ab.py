"""K2's wgmma weight gradient against the choices its design made, in
turns on one card.

    python3 -m crnerf_tpu_torch.tools.wgrad_ab

On the stash and dz buffer of the fused render's stash forward and chain
(8x256, C = 64, bf16, on seeded rays and cotangents) at the
stash route's two passes, 16,384 rays x 128 and x 64 samples, and on the
rows of one K3 slab of the fine pass: the weight gradient as the port runs
it (``ops.fused_render.bwd_wgrad``: clusters of two CTAs, a job's dz boxes
loaded once for both of its 128-row tiles, ``WGRAD_WAVES`` waves of items)
in turns with
  * the same kernel on a pair table in which no two tiles of a cluster
    read the same box, so that every CTA loads its own and the second read
    of a job's dz is left to the L2 (the clusters' multicast off, nothing
    else changed);
  * the port's plan at eight waves of items (more splits, larger partials);
  * the mma.sync kernel (128 x 128 tiles, cp.async).
Each line: ms (medians of 6 readings of ``turns_ms``), the share of the
bytes bound (stash and dz read once, the gradients written once, at 3.35
TB/s), the partials' MiB. Needs a card.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.tools._common import device_line, turns_ms

PEAK_BYTES = 3.35e12   # an H100 SXM's device memory, bytes a second


def unshared_pairs(table: torch.Tensor) -> torch.Tensor:
    """The pair table re-paired so that no cluster shares a box: the first
    tiles of two two-tile jobs together, then their second tiles; the
    one-tile jobs by stash column, the two encode jobs (one stash block) in
    separate clusters."""
    rows = table.tolist()
    pairs = [rows[i:i + 2] for i in range(0, len(rows), 2)]
    shared = [p for p in pairs if p[0][2] == p[1][2] and p[0][1] > 0]
    if len(shared) % 2:
        raise ValueError("an odd number of two-tile jobs")
    rest = [t for p in pairs if p not in shared for t in p]
    out = []
    for a, b in zip(shared[0::2], shared[1::2]):
        out += [a[0], b[0], a[1], b[1]]
    # the one-tile jobs: the two encode jobs (one stash block) apart
    rest.sort(key=lambda r: r[0])
    half = len(rest) // 2
    for a, b in zip(rest[:half], rest[half:]):
        out += [a, b]
    return torch.tensor(out, dtype=table.dtype, device=table.device)


@contextlib.contextmanager
def plan(pair_table=None, waves=None):
    """The port's weight-gradient plan with another pair table or another
    number of waves for the duration of the block."""
    saved = fr._pair_table, fr.WGRAD_WAVES
    if pair_table is not None:
        fr._pair_table = lambda lay, device_str: pair_table
    if waves is not None:
        fr.WGRAD_WAVES = waves
    try:
        yield
    finally:
        fr._pair_table, fr.WGRAD_WAVES = saved


def stash_and_dz(kw, n: int, s: int, device):
    """The stash forward's stash and the chain's dz buffer on seeded rays
    and cotangents."""
    gen = torch.Generator(device=device).manual_seed(5)
    o = torch.randn(n, 3, generator=gen, device=device) * 0.5
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=gen, device=device), dim=-1)
    z = torch.sort(torch.rand(n, s, generator=gen, device=device) * 4.0
                   + 0.5, -1).values
    noise = torch.randn(n, s, generator=gen, device=device)
    _, _, st = fr.render_fwd(kw, o, d, z, noise, False, stash=True)
    g_ray = torch.zeros(n, 128, device=device)
    g_ray[:, :65] = torch.randn(n, 65, generator=gen, device=device) * 0.1
    g_w = torch.randn(n, s, generator=gen, device=device) * 0.1
    dz, _ = fr.bwd_chain(kw, z, noise, fr.dir_block(kw, d, False), st,
                         g_ray, g_w)
    return st, dz


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("wgrad_ab: no CUDA device; the tool times kernels on a card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(device_line(device))
    from crnerf_tpu_torch.models.nerf_mlp import NerfMLP

    torch.manual_seed(0)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(device))
    kw = fr.prepare_kernel_weights(params, 15, 4, torch.bfloat16)
    lay = fr.grad_layout(kw.dims)
    unshared = unshared_pairs(fr._pair_table(lay, str(device)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n, s in ((16384, 128), (16384, 64)):
        st, dz = stash_and_dz(kw, n, s, device)
        slab = fr.slab_rays_for(kw, n, s, device) * s
        cases = [(f"{n} x {s}", n * s)]
        if s == 128:
            cases.append((f"a K3 slab ({slab} points)", slab))
        for name, m in cases:
            a, b = st[:m], dz[:m]
            bound = (m * (lay.sc + lay.dc) * 2 + lay.wt * 4) / PEAK_BYTES

            def run():
                return fr.bwd_wgrad(kw, a, b)

            def mib(waves):
                n_tiles = fr._pair_table(lay, str(device)).shape[0]
                with plan(waves=waves):
                    splits = fr.wgrad_splits("wgmma", n_tiles, m, sms)
                return splits * lay.wt * 4 / 2 ** 20

            def unshared_run():
                with plan(pair_table=unshared):
                    return fr.bwd_wgrad(kw, a, b)

            def eight_waves():
                with plan(waves=8):
                    return fr.bwd_wgrad(kw, a, b)

            for label, other in (
                    ("no box shared in a cluster (the L2 alone)",
                     unshared_run),
                    ("eight waves of items", eight_waves),
                    ("the mma.sync kernel",
                     lambda: fr.bwd_wgrad(kw, a, b, variant="mma"))):
                ms, ms_o = turns_ms(run, other, device, reps=3)
                print(f"{name}: the port's {ms:.3f} ms "
                      f"({100 * 1e3 * bound / ms:.0f}% of the bytes bound, "
                      f"{mib(None):.1f} MiB of partials) against {label} "
                      f"{ms_o:.3f} ms ({100 * 1e3 * bound / ms_o:.0f}%"
                      + (f", {mib(8):.1f} MiB" if "waves" in label else "")
                      + ")")
        del st, dz
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
