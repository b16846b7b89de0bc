"""The CR-NeRF system (``crnerf_tpu/render/system.py`` ``CrNerfSystem``).

Submodules carry the checkpoint prefixes: ``nerf_coarse``, ``nerf_fine``,
``enc_a``, ``enc_cont``, ``decoder``, ``implicit_mask``. ``forward_eval`` (the
``train=False`` half of the JAX ``forward``) runs the appearance encoder
and the CGNet mask on the style image, the coarse and fine passes
(``render.renderer``), and one batched StyleNet decode of the coarse and
fine feature maps; ``forward_eval_sharded`` splits its rays over the ranks
of a process group. ``forward_train`` (the ``train=True`` half) does the
same for the G grids of a training step at once, with the stochastic
renderer, the random-appearance branch and its re-encode, and with
``encode_c`` the content heads; where the JAX step maps ``forward`` over
the grids, every tensor here carries a leading G axis. The content heads
feed the training loss only: the eval forwards never run them (the JAX
package's inference passes ``want_content=False``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.models.appearance import AppearanceEncoder
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.models.common import sample_bilinear_uv
from crnerf_tpu_torch.models.decoder import get_renderer
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.models.style import StyleNet
from crnerf_tpu_torch.ops.fused_mlp import prepare_mlp_weights
from crnerf_tpu_torch.ops.fused_render import (
    mlp_params_from_module,
    prepare_kernel_weights,
)
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render.renderer import (
    Weights,
    render_rays_tiled,
    render_rays_train,
)


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def pixel_uv(hw: Tuple[int, int], device=None) -> torch.Tensor:
    """(h*w, 2) pixel-centre (v, u) coordinates, row-major."""
    h, w = hw
    vv, uu = torch.meshgrid(
        (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h,
        (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w,
        indexing="ij",
    )
    return torch.stack([vv.reshape(-1), uu.reshape(-1)], -1)


class CrNerfSystem(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        mk = lambda: NerfMLP(  # noqa: E731
            depth=cfg.netdepth, width=cfg.netwidth,
            in_channels_xyz=cfg.in_channels_xyz,
            in_channels_dir=cfg.in_channels_dir,
            out_dim=cfg.nerf_out_dim, compute_dtype=dt,
        )
        self.nerf_coarse = mk()
        self.nerf_fine = mk() if cfg.N_importance > 0 else None
        self.enc_a = (AppearanceEncoder(cfg.nerf_out_dim, dtype=dt)
                      if cfg.encode_a else None)
        self.enc_cont = (AppearanceEncoder(cfg.nerf_out_dim, dtype=dt)
                         if cfg.encode_c else None)
        self.decoder = (StyleNet(cfg.nerf_out_dim, dtype=dt) if cfg.encode_a
                        else get_renderer(cfg.nerf_out_dim, cfg.model_mode,
                                          dtype=dt))
        self.implicit_mask = (
            ContextGuidedNetwork(classes=1, M=2, N=2, input_channel=3)
            if cfg.use_mask else None
        )

    def kernel_weights(self) -> Dict[str, Optional[Weights]]:
        """The coarse and fine MLPs as the inference route of the config
        takes them (``render.renderer.render_rays``): laid out for the
        fused render kernel (``use_pallas`` and ``pallas_render``), for the
        fused MLP kernel (``pallas_render`` off), or the modules themselves
        (``use_pallas`` off). A layout is a snapshot of the parameters as
        they are now. A renderer of frozen weights prepares once and
        renders many frames; after any update of the parameters the layout
        is stale and must be made again. Training does not use it:
        ``forward_train`` hands the renderer the live parameters, which
        are laid out at every call."""
        cfg = self.cfg
        if not cfg.use_pallas:
            return {"coarse": self.nerf_coarse, "fine": self.nerf_fine}
        lay_out = (prepare_kernel_weights if cfg.pallas_render
                   else prepare_mlp_weights)
        prep = lambda m: lay_out(  # noqa: E731
            mlp_params_from_module(m), cfg.N_emb_xyz, cfg.N_emb_dir,
            compute_dtype(cfg), m.skips,
        )
        return {"coarse": prep(self.nerf_coarse),
                "fine": (prep(self.nerf_fine)
                         if self.nerf_fine is not None else None)}

    def render_kw(self) -> Dict:
        cfg = self.cfg
        bf16 = cfg.compute_dtype == "bfloat16"
        return dict(
            n_samples=cfg.N_samples, n_importance=cfg.N_importance,
            use_disp=cfg.use_disp,
            # the recurrence only where its ~2e-4 error is below the
            # compute stream's own rounding (bf16), as in the JAX package
            exact_encode=not (cfg.fast_sincos and bf16),
        )

    def encode_appearance(self, whole01: torch.Tensor) -> torch.Tensor:
        """(1, Ha, Wa, 3) in [0, 1] -> (1, 32, 32, C)."""
        return self.enc_a(whole01)

    def predict_mask(self, whole01: torch.Tensor) -> torch.Tensor:
        """CGNet over the style image -> (1, Ha, Wa, 1)."""
        return self.implicit_mask(whole01)

    def decode(self, fmap: torch.Tensor, style,
               kind: Optional[str] = None) -> torch.Tensor:
        if self.cfg.encode_a:
            return self.decoder(fmap, style, kind=kind)
        return self.decoder(fmap)

    def forward_train(
        self,
        batch: Dict[str, torch.Tensor],
        a_embedded_random: Optional[torch.Tensor] = None,
        random_has_any: bool = True,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The cross-ray forward pass of training over G grids.

        batch: rays (G, B, 8), rgbs (G, B, 3), whole_img (G, 1, Ha, Wa, 3)
        in [-1, 1], uv_pix (G, B, 2) pixel-centre coordinates of the
        sampled pixels; B = grid_hw^2 rays, row-major. a_embedded_random
        (G, 32, 32, C): the cached style embedding chosen for each grid
        (the choice is the train step's, where the cache lives); None
        turns the random branch off. random_has_any False (empty cache):
        the live embedding takes its place, with gradient. ``draws``: the
        renderer's random inputs over the G*B rays (``render_rays_train``).

        Returns the results with a leading G axis: rgb_coarse, rgb_fine,
        rgb_fine_random (G, B, 3), out_mask (G, B, 1), a_embedded,
        a_embedded_random, a_embedded_random_rec (G, 32, 32, C), with
        ``encode_c`` content_with_a_embed and content_wo_a_embed (G, 32, 32,
        C): ``enc_cont`` of the styled and of the unstyled fine decode, and
        the renderer's per-ray outputs (G, B, ...). The module must be in
        training mode for CGNet to use batch statistics (``self.train()``).
        """
        cfg = self.cfg
        g, b = batch["rays"].shape[:2]
        h = w = cfg.grid_hw
        res: Dict[str, torch.Tensor] = {}
        whole01 = (batch["whole_img"][:, 0] + 1.0) / 2.0   # (G, Ha, Wa, 3)
        a_emb = None
        if cfg.encode_a:
            a_emb = self.encode_appearance(whole01)
            res["a_embedded"] = a_emb
        if cfg.use_mask:
            mask_small = self.predict_mask(whole01)          # (G, Ha, Wa, 1)
            res["out_mask"] = torch.stack(
                [sample_bilinear_uv(mask_small[i], batch["uv_pix"][i])
                 for i in range(g)], 0)
        # the fused routes take live (in, out) views of the parameters, the
        # module route the modules
        params = ((lambda m: mlp_params_from_module(m, detach=False))
                  if cfg.pallas_train else (lambda m: m))
        bf16 = cfg.compute_dtype == "bfloat16"
        rr = render_rays_train(
            params(self.nerf_coarse),
            params(self.nerf_fine) if self.nerf_fine is not None else None,
            batch["rays"].reshape(g * b, 8),
            n_samples=cfg.N_samples, n_importance=cfg.N_importance,
            n_emb_xyz=cfg.N_emb_xyz, n_emb_dir=cfg.N_emb_dir,
            use_disp=cfg.use_disp, perturb=cfg.perturb,
            noise_std=cfg.noise_std, compute_dtype=compute_dtype(cfg),
            exact_encode=not (cfg.fast_sincos and bf16),
            skips=self.nerf_coarse.skips, pertube_cord=cfg.pertube_cord,
            stash=cfg.pallas_stash, full=cfg.pallas_render,
            remat=cfg.remat, generator=generator, draws=draws,
        )
        res.update({k: v.reshape(g, b, *v.shape[1:]) for k, v in rr.items()})
        has_fine = "feature_fine" in rr
        fc_map = rr["feature_coarse"].reshape(g, h, w, -1)
        ff_map = rr["feature_fine"].reshape(g, h, w, -1) if has_fine else None
        do_random = (cfg.encode_a and cfg.encode_random and has_fine
                     and a_embedded_random is not None)
        want_c = cfg.encode_c and has_fine
        if do_random:
            a_rand = (a_embedded_random.to(a_emb.dtype) if random_has_any
                      else a_emb)
        if cfg.encode_a and has_fine:
            # one batched StyleTransform + decoder pass over every styled
            # map, the raw fine maps of the content path appended: the
            # style statistics are per sample, so the order of the batch
            # does not matter
            maps, styles = [fc_map, ff_map], [a_emb, a_emb]
            if do_random:
                maps.append(ff_map)
                styles.append(a_rand)
            imgs = self.decoder.decode_batch(torch.cat(maps, 0),
                                             torch.cat(styles, 0),
                                             ff_map if want_c else None)
            res["rgb_coarse"] = imgs[:g].reshape(g, b, 3)
            rgb_fine_img = imgs[g:2 * g]
            rgb_rand_img = imgs[2 * g:3 * g] if do_random else None
            rgb_content_img = imgs[-g:] if want_c else None
        else:
            res["rgb_coarse"] = self.decode(fc_map, a_emb).reshape(g, b, 3)
            if has_fine:
                rgb_fine_img = self.decode(ff_map, a_emb)
            if want_c:
                rgb_content_img = self.decode(ff_map, None, kind="content")
        if has_fine:
            res["rgb_fine"] = rgb_fine_img.reshape(g, b, 3)
        if do_random:
            res["a_embedded_random"] = a_rand
            # re-encode the random-styled render; the loss holds it to the
            # chosen embedding
            res["a_embedded_random_rec"] = self.enc_a(rgb_rand_img)
            res["rgb_fine_random"] = rgb_rand_img.reshape(g, b, 3)
        if want_c:
            # both content embeddings in one encoder pass over 2G images
            both = self.enc_cont(torch.cat([rgb_fine_img, rgb_content_img],
                                           0))
            res["content_with_a_embed"] = both[:g]
            res["content_wo_a_embed"] = both[g:]
        return res

    @torch.no_grad()
    def forward_eval(self, rays: torch.Tensor, uv: torch.Tensor,
                     whole_img: torch.Tensor, hw: Tuple[int, int],
                     kernel_weights: Dict[str, Optional[Weights]],
                     want_mask: bool = True,
                     tile: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """rays (h*w, 8), pixel-centre uv (h*w, 2), whole_img (1, Ha, Wa, 3)
        in [-1, 1], ``kernel_weights()`` -> rgb_fine, rgb_coarse (h*w, 3),
        depth_fine, depth_coarse (h*w,), out_mask (h*w, 1). A caller that
        needs only rgb skips CGNet with ``want_mask=False`` (the JAX
        package's jitted u8 program drops it the same way). ``tile``: rays
        a render launch (default ``Config.chunk``); each ray's result is
        the same whatever the tile."""
        rr = self._render_eval(rays, kernel_weights, tile)
        return self._decode_eval(rr, uv, whole_img, hw, want_mask)

    @torch.no_grad()
    def forward_eval_sharded(self, rays: torch.Tensor, uv: torch.Tensor,
                             whole_img: torch.Tensor, hw: Tuple[int, int],
                             kernel_weights: Dict[str, Optional[Weights]],
                             group, want_mask: bool = True,
                             tile: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
        """``forward_eval`` with the rays split over the ranks of ``group``
        (``crnerf_tpu/render/system.py`` ``forward_eval_sharded``): each
        rank renders its ``mesh.shard_rows`` slice, the per-ray features
        and depths are gathered in rank order and cut back to h*w, and the
        style decode (its MulLayer takes Gram statistics over the whole
        map) and CGNet run on every rank. Every rank gets the whole result,
        the bits of ``forward_eval`` (a ray's result does not depend on the
        tile it is rendered in). Every rank passes the same arguments."""
        d, r = mesh.world_size(group), mesh.rank(group)
        local = self._render_eval(mesh.local_rows(rays, d, r),
                                  kernel_weights, tile)
        n = rays.shape[0]
        rr = {k: mesh.all_gather_rows(v, group)[:n]
              for k, v in sorted(local.items())}
        return self._decode_eval(rr, uv, whole_img, hw, want_mask)

    def _render_eval(self, rays: torch.Tensor,
                     kernel_weights: Dict[str, Optional[Weights]],
                     tile: Optional[int]) -> Dict[str, torch.Tensor]:
        """The coarse and fine passes of ``rays`` -> per-ray features and
        depths."""
        rr = render_rays_tiled(kernel_weights["coarse"],
                               kernel_weights["fine"], rays,
                               tile=tile or self.cfg.chunk,
                               **self.render_kw())
        return {k: v for k, v in rr.items()
                if k.startswith(("feature_", "depth_"))}

    def _decode_eval(self, rr: Dict[str, torch.Tensor], uv: torch.Tensor,
                     whole_img: torch.Tensor, hw: Tuple[int, int],
                     want_mask: bool) -> Dict[str, torch.Tensor]:
        """The image-level half of the eval forward: the appearance
        embedding and the CGNet mask of the style image, and the decode of
        the per-ray features ``rr`` of all h*w pixels."""
        cfg = self.cfg
        h, w = hw
        res: Dict[str, torch.Tensor] = {}
        whole01 = (whole_img + 1.0) / 2.0
        a_emb = self.encode_appearance(whole01) if cfg.encode_a else None
        if cfg.use_mask and want_mask:
            mask_small = self.predict_mask(whole01)
            res["out_mask"] = sample_bilinear_uv(mask_small[0], uv)
        res["depth_coarse"] = rr["depth_coarse"]
        fc_map = rr["feature_coarse"].reshape(1, h, w, -1)
        has_fine = "feature_fine" in rr
        if has_fine:
            res["depth_fine"] = rr["depth_fine"]
            ff_map = rr["feature_fine"].reshape(1, h, w, -1)
        if cfg.encode_a and has_fine:
            imgs = self.decoder.decode_batch(torch.cat([fc_map, ff_map], 0),
                                             torch.cat([a_emb, a_emb], 0))
            res["rgb_coarse"] = imgs[0].reshape(-1, 3)
            res["rgb_fine"] = imgs[1].reshape(-1, 3)
        else:
            res["rgb_coarse"] = self.decode(fc_map, a_emb).reshape(-1, 3)
            if has_fine:
                res["rgb_fine"] = self.decode(ff_map, a_emb).reshape(-1, 3)
        return res
