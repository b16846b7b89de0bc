"""The yardstick: published peaks of one H100 SXM, and the operations and
bytes of the cells' work computed from the configurations' widths alone.

Frozen copies of ``chip_smoke.py``'s ``mlp_work``, ``bound`` and
``train_kernel_bounds`` and of the fused render kernels' stash layout
(``ops/fused_render.py`` ``_grad_layout``), written over widths instead of
the program's weight objects so that nothing here reads the program.
Operations count products only, 2 FLOP a multiply-add. No recompute is
counted in the model FLOPs of a step or a frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, bf16: bool = True
          ) -> Tuple[float, str]:
    """-> (bound_ms, bound_by): the larger of operations over the peak rate
    of their type and bytes over the memory rate."""
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


@dataclasses.dataclass(frozen=True)
class Mlp:
    """The widths of one NeRF MLP (``NerfMLP``): a ReLU trunk of ``depth``
    layers of ``width`` over the xyz encode, the encode fed in again at the
    ``skips``, a sigma head, a final layer, a direction layer to width / 2
    over [final | dir encode], and a feature head to ``out_dim``."""
    depth: int = 8
    width: int = 256
    n_emb_xyz: int = 15
    n_emb_dir: int = 4
    out_dim: int = 64
    skips: Tuple[int, ...] = (4,)

    @property
    def d_xyz(self) -> int:
        return 3 + 6 * self.n_emb_xyz

    @property
    def d_dir(self) -> int:
        return 3 + 6 * self.n_emb_dir

    def trunk_shapes(self) -> List[Tuple[int, int]]:
        """(in, out) of each trunk layer."""
        return [(self.d_xyz if i == 0 else
                 self.width + (self.d_xyz if i in self.skips else 0),
                 self.width) for i in range(self.depth)]

    @classmethod
    def of(cls, cfg: Dict) -> "Mlp":
        return cls(depth=cfg["netdepth"], width=cfg["netwidth"],
                   n_emb_xyz=cfg["N_emb_xyz"], n_emb_dir=cfg["N_emb_dir"],
                   out_dim=cfg["nerf_out_dim"])


def mlp_work(m: Mlp, per_dir: float) -> Tuple[float, float, float]:
    """Operations per sample point of one pass: (forward, backward chain,
    backward weight gradient) in FLOP. The dir layer's dir-encode rows make
    a term per direction, shared by the ``per_dir`` points of a ray."""
    w, hp = m.width, m.width // 2
    trunk = m.trunk_shapes()
    mats = sum(i * o for i, o in trunk) + w * 1 + w * w + w * hp \
        + hp * m.out_dim
    fwd = 2.0 * (mats + m.d_dir * hp / per_dir)
    hidden = sum(i - (m.d_xyz if i > w else 0) for i, _ in trunk[1:]) * w
    chain = 2.0 * (2 * w * 1 + 3 * hp * m.out_dim + w * hp + w * w + hidden)
    return fwd, chain, fwd


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


@dataclasses.dataclass(frozen=True)
class StashLayout:
    """Columns of the fused render kernels' stash (``sc``) and dz buffer
    (``dc``) a point, the weight-gradient buffer (``wt``) and the offset
    of the final layer's columns (``o_hf``): ``_grad_layout``'s
    arithmetic."""
    sc: int
    dc: int
    wt: int
    o_hf: int
    hp: int


def stash_layout(m: Mlp) -> StashLayout:
    wp, hp, cp = m.width, m.width // 2, m.out_dim
    ke = _round_up(m.d_xyz, 16)
    n = m.depth
    o_hf, o_dd = n * wp, (n + 1) * wp
    o_enc = o_dd + hp
    d_feat = (n + 1) * wp + 32 + hp
    wt = 0
    for i in range(n):
        if i == 0 or i in m.skips:
            wt += ke * wp
        if i > 0:
            wt += wp * wp
    wt += wp * wp + wp * 32 + wp * hp + hp * cp
    return StashLayout(sc=o_enc + ke, dc=d_feat + cp, wt=wt, o_hf=o_hf,
                       hp=hp)


def train_pass_bounds(m: Mlp, n: int, s: int, bf16: bool = True
                      ) -> Dict[str, Tuple[float, str]]:
    """The stash route's three kernels over one pass of ``n`` rays of
    ``s`` points: the stash forward (K1-stash), K2's chain and K2's weight
    gradient, each alone (the chain writes the dz buffer and the weight
    gradient reads it back)."""
    lay = stash_layout(m)
    esz = 2 if bf16 else 4
    pts = n * s
    f_fwd, f_chain, f_wgrad = mlp_work(m, s)
    return dict(
        fwd_stash=bound(pts * f_fwd, pts * lay.sc * esz, bf16),
        chain=bound(pts * f_chain, pts * (lay.o_hf + lay.hp + lay.dc) * esz,
                    bf16),
        wgrad=bound(pts * f_wgrad, pts * (lay.sc + lay.dc) * esz
                    + lay.wt * 4, bf16),
    )


def render_fwd_bound(m: Mlp, n: int, s: int, bf16: bool = True
                     ) -> Tuple[float, str]:
    """K1, the inference forward, over ``n`` rays of ``s`` points: per ray
    it reads [o | d], z, noise and the dir encode and writes the ray block
    (C + 1 + 64 padded to 128) and the weights, all fp32."""
    f_fwd, _, _ = mlp_work(m, s)
    return bound(n * s * f_fwd, n * (8 + 2 * s + 27 + 128 + s) * 4, bf16)


# ------------------------------------------------------------ convolutions
# A layer: (kind, c_in, c_out, k, stride, groups, at) where ``at`` names the
# resolution the layer's output lives at: "in" the network's input, "/2",
# "/4", "/8" strided or pooled from it, "emb" the 32x32 embedding. "fc" is
# a dense layer on a per-image vector (resolution 1).
ENC_A: Sequence[tuple] = (
    ("conv", 3, 3, 1, 1, 1, "in"), ("conv", 3, 64, 3, 1, 1, "in"),
    ("conv", 64, 64, 3, 1, 1, "in"), ("conv", 64, 128, 3, 1, 1, "/2"),
    ("conv", 128, 128, 3, 1, 1, "/2"), ("conv", 128, 128, 3, 1, 1, "/4"),
    ("conv", 128, "C", 1, 1, 1, "emb"))

CGNET: Sequence[tuple] = (
    ("conv", 3, 32, 3, 2, 1, "s2"), ("conv", 32, 32, 3, 1, 1, "s2"),
    ("conv", 32, 32, 3, 1, 1, "s2"),
    # level 2: a down block (35 -> 64) and one residual block
    ("conv", 35, 64, 3, 2, 1, "s4"), ("conv", 64, 64, 3, 1, 64, "s4"),
    ("conv", 64, 64, 3, 1, 64, "s4"), ("conv", 128, 64, 1, 1, 1, "s4"),
    ("fc", 64, 8), ("fc", 8, 64),
    ("conv", 64, 32, 1, 1, 1, "s4"), ("conv", 32, 32, 3, 1, 32, "s4"),
    ("conv", 32, 32, 3, 1, 32, "s4"), ("fc", 64, 8), ("fc", 8, 64),
    # level 3: a down block (131 -> 128) and one residual block
    ("conv", 131, 128, 3, 2, 1, "s8"), ("conv", 128, 128, 3, 1, 128, "s8"),
    ("conv", 128, 128, 3, 1, 128, "s8"), ("conv", 256, 128, 1, 1, 1, "s8"),
    ("fc", 128, 8), ("fc", 8, 128),
    ("conv", 128, 64, 1, 1, 1, "s8"), ("conv", 64, 64, 3, 1, 64, "s8"),
    ("conv", 64, 64, 3, 1, 64, "s8"), ("fc", 128, 8), ("fc", 8, 128),
    ("conv", 256, 1, 1, 1, 1, "s8"))


def _at(at: str, hw: Tuple[int, int]) -> int:
    """Pixels of a layer's output for an (h, w) input."""
    h, w = hw
    if at == "in":
        return h * w
    if at == "emb":
        return 32 * 32
    if at.startswith("/"):          # floor pooling
        d = int(at[1:])
        return (h // d) * (w // d)
    d = int(at[1:])                  # stride-2 convs with padding: ceil
    for _ in range({2: 1, 4: 2, 8: 3}[d]):
        h, w = -(-h // 2), -(-w // 2)
    return h * w


def net_flops(layers: Sequence[tuple], hw: Tuple[int, int], c: int) -> float:
    """Forward FLOP of one image through a table of layers."""
    total = 0.0
    for layer in layers:
        if layer[0] == "fc":
            total += 2.0 * layer[1] * layer[2]
            continue
        _, ci, co, k, _, groups, at = layer
        co = c if co == "C" else co
        total += 2.0 * _at(at, hw) * co * (ci // groups) * k * k
    return total


def stylenet_flops(hw: Tuple[int, int], c: int, styled: bool,
                   m: int = 32) -> float:
    """Forward FLOP of the StyleNet decode of one (h, w, C) map: with
    ``styled`` the style transform (compress, the content and style gram
    towers over the map and the 32x32 embedding, the gram products, their
    FC layers, the transform's two products, unzip), then the 1x1 decoder
    to rgb."""
    p = hw[0] * hw[1]
    dec = 2.0 * p * c * 3
    if not styled:
        return dec

    def gram(pix):
        tower = 2.0 * pix * (c * 128 + 128 * 64 + 64 * m)
        return tower + 2.0 * pix * m * m + 2.0 * (m * m) ** 2

    return (2.0 * p * c * m + gram(p) + gram(32 * 32) + 2.0 * m ** 3
            + 2.0 * p * m * m + 2.0 * p * m * c + dec)


def step_flops(cfg: Dict) -> float:
    """Model FLOP of one training step of ``grids_per_step`` grids of
    ``batch_size`` rays: the MLP products of the coarse and the fine pass,
    three times (forward, chain, weight gradient), and forward plus
    backward (three times the forward) of the convolutions: enc_a over
    each grid's style image and its random-styled render, enc_cont over
    the styled and the unstyled fine render, CGNet over the style image,
    and the StyleNet decodes (coarse, fine, random-styled, unstyled)."""
    m = Mlp.of(cfg)
    g, b = cfg["grids_per_step"], cfg["batch_size"]
    sc, sf = cfg["N_samples"], cfg["N_samples"] + cfg["N_importance"]
    mlp = 3.0 * g * b * (sc * mlp_work(m, sc)[0] + sf * mlp_work(m, sf)[0])
    wa, ha = cfg["appearance_wh"]
    side = int(round(b ** 0.5))
    grid = (side, side)
    c = cfg["nerf_out_dim"]
    per_grid = net_flops(ENC_A, (ha, wa), c)
    if cfg.get("use_mask"):
        per_grid += net_flops(CGNET, (ha, wa), c)
    if cfg.get("encode_random"):
        per_grid += net_flops(ENC_A, grid, c)
        per_grid += stylenet_flops(grid, c, True)
    if cfg.get("encode_c"):
        per_grid += 2 * net_flops(ENC_A, grid, c)
        per_grid += stylenet_flops(grid, c, False)
    per_grid += 2 * stylenet_flops(grid, c, True)
    return mlp + 3.0 * g * per_grid


def frame_flops(cfg: Dict, wh: Tuple[int, int]) -> float:
    """Model FLOP of one served (w, h) frame: the coarse and the fine
    forward of every ray, enc_a over the style image, and the StyleNet
    decode of the coarse and the fine map."""
    m = Mlp.of(cfg)
    n = wh[0] * wh[1]
    sc, sf = cfg["N_samples"], cfg["N_samples"] + cfg["N_importance"]
    mlp = n * (sc * mlp_work(m, sc)[0] + sf * mlp_work(m, sf)[0])
    wa, ha = cfg["appearance_wh"]
    c = cfg["nerf_out_dim"]
    return (mlp + net_flops(ENC_A, (ha, wa), c)
            + 2 * stylenet_flops((wh[1], wh[0]), c, True))
