"""Spread of two checks of ``chip_smoke.py`` over many draws of their inputs.

    python3 -m crnerf_tpu_torch.tools.draw_spread recompute --seeds 0:60
    python3 -m crnerf_tpu_torch.tools.draw_spread slabs --seeds 0:50

``recompute``: the wgmma recompute backward (K3) at the no-stash step's
fine pass, 16,384 rays x 128, rays-in, bf16, against its plain version
from the same inputs (phase 4b's reading, bound ``RECOMPUTE_VS_PLAIN``),
first on the draw phase 4b keeps (``chip_smoke.knife_edge_draw``), then on
a generator seeded with each seed. Per draw it prints the reading, the
ReLUs open in the kernel's forward and shut in the plain one's
(``chip_smoke.relu_flips``) and, where a ray's last sample has one, the
reading with those points' rows given the kernel's masks.

``slabs``: the mma.sync fused-MLP backward (K4-bwd) at 1024 x 128 fp32 at
its own slab size against one slab (phase 4d's reading, once held to 1e-5
of each tensor's largest gradient), first on the kept draw
(``chip_smoke.slab_edge_draw``),
then per seed; per draw the reading per gradient tensor and the largest
difference in standard deviations of the error model
``chip_smoke.slab_sum_z``, over the weight gradients and over the bias
vector.

Run from the repository's root (it imports ``chip_smoke``). Needs a GPU;
the card's name and power limit come first. ``--budget`` stops the sweep
after that many seconds.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

import chip_smoke as cs
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr
from crnerf_tpu_torch.tools._common import device_line

NAMES = ([f"trunk_w{i}" for i in range(8)] + [f"trunk_b{i}" for i in range(8)]
         + ["sigma_w", "sigma_b", "final_w", "final_b", "dir_w", "dir_b",
            "feat_w", "feat_b"])


def recompute_draw(params, gen, dev, tag: str,
                   n: int = cs.TRAIN_GRIDS * 1024, s: int = 128) -> float:
    dt = torch.bfloat16
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    lay = fr.grad_layout(kw.dims)
    o, d, z, noise, _, g_ray, g_w = cs.recompute_inputs(n, s, gen, dev,
                                                        False)
    dir_blk = fr.dir_block(kw, d, False)
    slices = cs.ray_slices(n)

    def plain_on(parts, swap=None):
        """The plain backward on a stash's slices; ``swap``: (a stash,
        points) whose rows replace those points' rows."""
        gw = torch.zeros(lay.wt, dtype=torch.float64, device=dev)
        gb = torch.zeros(lay.bt, dtype=torch.float64, device=dev)
        for sl, rows in zip(slices, parts):
            lo, hi = sl.start * s, sl.stop * s
            if swap is not None:
                mine = swap[1][(swap[1] >= lo) & (swap[1] < hi)]
                if mine.numel():
                    rows = rows.clone()
                    rows[mine - lo] = swap[0][mine]
            dz_p, gb_s = fr.bwd_chain_plain(kw, z[sl], noise[sl],
                                            dir_blk[sl], rows, g_ray[sl],
                                            g_w[sl])
            gw += fr.bwd_wgrad_plain(kw, rows, dz_p)
            gb += gb_s
        return fr.flatten_params(fr.unpack_grads(kw, gw, gb))

    with cs.full_fp32():
        st_p = [fr.render_fwd_plain(params, o[sl], d[sl], z[sl], noise[sl],
                                    15, 4, dt, False, stash=True)[2]
                for sl in slices]
        want = plain_on(st_p)
        gw, gb, _ = fr.bwd_recompute(kw, o, d, z, noise, g_ray, g_w, False,
                                     variant="wgmma")
        got = fr.flatten_params(fr.unpack_grads(kw, gw, gb))
        _, _, st = fr.render_fwd(kw, o, d, z, noise, False, stash=True,
                                 variant="wgmma")
        flips = cs.relu_flips(kw, st, st_p, noise, cs.STASH_TOL_BF16[1],
                              fm.KERNEL_TOL[dt][1])
        same = None
        if flips["rows"].numel():
            same = plain_on(st_p, (st, flips["rows"]))
        del st, st_p
    rels = [float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
            for a, b in zip(want, got)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    line = (f"{tag}: reading {rels[worst]:.3e} ({NAMES[worst]}; bound "
            f"{cs.RECOMPUTE_VS_PLAIN['bfloat16']}); flips: "
            f"{flips['trunk']} trunk/dir entries ({flips['trunk_last']} at "
            f"a last sample), {flips['sigma']} sigma ({flips['sigma_last']} "
            f"at a last sample), {flips['rows'].numel()} last-sample points, "
            f"{flips['unexplained']} beyond the stated difference (margin "
            f"{flips['margin']:.3f})")
    if same is not None:
        r_same = max(float((a - b).abs().max()
                           / c.abs().max().clamp_min(1e-30))
                     for a, b, c in zip(same, got, want))
        line += f"; with those points' masks the kernel's {r_same:.3e}"
    print(line, flush=True)
    for ex in flips["examples"]:
        print(f"    {ex}", flush=True)
    return rels[worst]


def slabs_draw(params, gen, dev, tag: str, n: int = cs.N_RAYS,
               s: int = 128) -> float:
    dt = torch.float32
    mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
    xyz, d, g_feat, g_sig = cs.mlp_bwd_inputs(n, s, gen, dev)
    m = xyz.shape[0]
    with cs.full_fp32():
        slab = fm.slab_points_for(mkw, m, dev)
        gw_a, gb_a, _ = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, True, s,
                                   variant="mma")
        gw_b, gb_b, (st, dz) = fm.mlp_bwd(mkw, xyz, d, g_feat, g_sig, True,
                                          s, slab_points=m, variant="mma")
        z_w, z_b = cs.slab_sum_z(mkw, st, dz, gw_a, gb_a, gw_b, gb_b, m,
                                 slab, m, dev)
    a = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_a, gb_a))
    b = fr.flatten_params(fm.unpack_mlp_grads(mkw, gw_b, gb_b))
    rels = [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
            for x, y in zip(a, b)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    top = sorted(range(len(rels)), key=rels.__getitem__)[-3:][::-1]
    print(f"{tag}: slabs of {slab} against one slab: reading "
          f"{rels[worst]:.3e} ({NAMES[worst]}; the former bound 1e-5); "
          f"largest three "
          f"{[(NAMES[i], f'{rels[i]:.3e}') for i in top]}; largest "
          f"difference in standard deviations of the error model: weight "
          f"gradients {z_w:.2f}, bias vector {z_b:.2f} (bound "
          f"{cs.SLAB_SUM_SIGMAS})", flush=True)
    return rels[worst]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("check", choices=("recompute", "slabs"))
    p.add_argument("--seeds", default="0:50", help="first:last (exclusive)")
    p.add_argument("--budget", type=float, default=600.0,
                   help="seconds of the sweep")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("draw_spread: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(device_line(dev), flush=True)
    params = cs.full_width_params(cs.SEED, dev)
    run = recompute_draw if args.check == "recompute" else slabs_draw
    kept = (cs.knife_edge_draw if args.check == "recompute"
            else cs.slab_edge_draw)(dev, cs.SEED)
    run(params, kept, dev, "kept draw")
    first, last = (int(x) for x in args.seeds.split(":"))
    t0, readings = time.perf_counter(), []
    for seed in range(first, last):
        if time.perf_counter() - t0 > args.budget:
            break
        gen = torch.Generator(device=dev).manual_seed(seed)
        readings.append(run(params, gen, dev, f"seed {seed}"))
    readings.sort()
    print(f"{len(readings)} seeds: readings from {readings[0]:.3e} to "
          f"{readings[-1]:.3e}, median {readings[len(readings) // 2]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
