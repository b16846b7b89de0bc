"""Digest of the forward kernels' outputs on seeded inputs.

    python3 -m crnerf_tpu_torch.tools.fwd_bits

Prints one sha256 per case (bf16 and fp32, exact encode and recurrence,
1024 rays x 256 samples, 8x256, C=64) over the bytes of the ray block and
the weights of the fused render's inference forward, with the variant that
took it (``render_variant``: wgmma at bf16, mma.sync at fp32); then per
case of the training forwards (the same dtypes and encodes, the first 256
rays) one over the ray block, the weights and the stash of the stash
forward on the mma.sync kernel, one over the ray block and the weights of
the xyz-in forward on the rays' sample points on the mma.sync kernel, at
bf16 one over the stash forward on the wgmma kernel (the stash route's),
and one each over the no-stash training forward of routes A (rays-in) and
B (xyz-in) as ``fused_render_train(stash=False)`` runs it, with its
variant (``recompute_variant``) and whether its outputs are the inference
forward's bits on the same rays; then per case the fused MLP's forward
(``ops.fused_mlp``) on those rays' sample points, one direction a ray, on
each variant the case takes (wgmma at bf16 and mma.sync), and route C's
training forward (``fused_mlp_train``) with its variant
(``mlp_bwd_variant``) and whether its outputs are that variant's
inference forward's bits. The kernels have
no atomics and a fixed order of sums, so two builds that compute the same
function print the same digests on the same card: run it in two checkouts
to show that a change to a kernel's source left its launches
bit-identical.
"""

from __future__ import annotations

import hashlib
import sys

import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_mlp as fm
from crnerf_tpu_torch.ops import fused_render as fr


def _digest(ts) -> str:
    return hashlib.sha256(b"".join(
        t.contiguous().cpu().view(torch.uint8).numpy().tobytes()
        for t in ts)).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_bits: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=8, width=256, out_dim=64).to(dev))
    gen = torch.Generator().manual_seed(1)
    n, s = 1024, 256
    o = (torch.randn(n, 3, generator=gen) * 0.5).to(dev)
    d = torch.randn(n, 3, generator=gen)
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(dev)
    z = torch.sort(torch.rand(n, s, generator=gen) * 4.0 + 0.5,
                   -1).values.to(dev)
    noise = torch.randn(n, s, generator=gen).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        kw = fr.prepare_kernel_weights(params, 15, 4, dt)
        for exact in (True, False):
            blk, w = fr.fused_render_apply(kw, o, d, z, noise, exact)
            torch.cuda.synchronize()
            h = hashlib.sha256(blk.cpu().numpy().tobytes()
                               + w.cpu().numpy().tobytes()).hexdigest()
            print(f"{str(dt)[6:]} exact={exact} "
                  f"({fr.render_variant(kw.dims)}) {h}")
    m = 256
    pts = (o[:m, None, :] + d[:m, None, :] * z[:m, :, None]).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        kw = fr.prepare_kernel_weights(params, 15, 4, dt)
        for exact in (True, False):
            outs = fr.render_fwd(kw, o[:m], d[:m], z[:m], noise[:m], exact,
                                 stash=True, variant="mma")
            outs += fr.render_fwd(kw, None, d[:m], z[:m], noise[:m], exact,
                                  stash=False, xyz=pts, variant="mma")[:2]
            cases = [("stash", "mma", outs[:3]), ("xyz-in", "mma", outs[3:])]
            if fr.render_variant(kw.dims) == "wgmma":
                cases.append(("stash", "wgmma", fr.render_fwd(
                    kw, o[:m], d[:m], z[:m], noise[:m], exact, stash=True)))
            torch.cuda.synchronize()
            for name, variant, ts in cases:
                print(f"{str(dt)[6:]} exact={exact} {name} ({variant}) "
                      f"{_digest(ts)}")
            # routes A and B: the no-stash training forward as the
            # autograd Function runs it, beside the inference forward
            variant = fr.recompute_variant(kw.dims, s)
            for name, org, xyz in (("no-stash training", o[:m], None),
                                   ("no-stash training xyz-in", None, pts)):
                got = fr.fused_render_train(
                    params, org, d[:m], z[:m], noise[:m], 15, 4, dt, exact,
                    xyz=xyz, stash=False)
                inf = fr.fused_render_apply(kw, org, d[:m], z[:m],
                                            noise[:m], exact, xyz=xyz)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, inf))
                print(f"{str(dt)[6:]} exact={exact} {name} ({variant}; the "
                      f"inference forward's bits: {same}) {_digest(got)}")
    # the fused MLP's forward on the same rays' points, each variant
    xyz = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    for dt in (torch.bfloat16, torch.float32):
        mkw = fm.prepare_mlp_weights(params, 15, 4, dt)
        for exact in (True, False):
            for variant in dict.fromkeys((fm.mlp_variant(mkw.kw.dims),
                                          "mma")):
                out = fm.mlp_fwd(mkw, xyz, d, exact, s, variant=variant)
                torch.cuda.synchronize()
                print(f"{str(dt)[6:]} exact={exact} fused MLP ({variant}) "
                      f"{_digest(out)}")
            # route C: the training forward as the autograd Function runs
            # it, on the backward's variant, beside that variant's
            # inference forward
            variant = fm.mlp_bwd_variant(mkw.kw.dims)
            got = fm.fused_mlp_train(params, xyz, d, 15, 4, dt, exact,
                                     dir_rep=s)
            inf = fm.mlp_fwd(mkw, xyz, d, exact, s, variant=variant)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, inf))
            print(f"{str(dt)[6:]} exact={exact} route C training forward "
                  f"({variant}; the inference forward's bits: {same}) "
                  f"{_digest(got)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
