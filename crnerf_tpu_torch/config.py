"""The port's configuration: the fields of ``crnerf_tpu/config.py``
``Config`` that the serving path, the training step, the data, the trainer
and the apps read, with the same names and defaults
(``tests/test_torch_imports.py`` holds them equal), and the CLI that parses
them (``build_parser`` / ``get_config``: paired ``--flag`` / ``--no-flag``
switches for every boolean, ``--testit`` forcing one epoch). The
port keeps its own copy so that it runs where only ``crnerf_tpu_torch/`` is
present. The TPU-only knobs (tile sizes, slab feeding, conv schedules, the
interpreter switch) have no counterpart here. The routing fields keep their
names because each selects between routes that exist here too:
``pallas_stash`` between the stash backward and the recompute backward,
which trade device memory for time on this card as they do on the TPU;
``use_pallas`` (inference) and ``pallas_train`` (training) between the
hand-written kernels and the ``NerfMLP`` module under autograd, with
``remat``; ``pallas_render`` between the fused render kernels and the fused
MLP kernels followed by compositing in plain PyTorch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class Config:
    # ---- dataset ----
    root_dir: str = ""
    dataset_name: str = "phototourism"  # 'phototourism' | 'blender' |
    # 'synthetic'
    scene_name: str = "test"
    split: str = "val"  # eval app: val | test | test_train | test_test
    img_downscale: int = 2
    img_wh: Tuple[int, int] = (800, 800)  # blender / camera-path renders
    data_perturb: Tuple[str, ...] = ()  # blender train split: a subset of
    # {"color", "occ"}
    use_cache: bool = True  # phototourism: read cache_tpu/scene_ds{N}.npz
    # when it exists
    testit: bool = False  # smoke mode: 1 epoch, 1 iteration per epoch

    # ---- NeRF core ----
    N_emb_xyz: int = 15
    N_emb_dir: int = 4
    N_samples: int = 64
    N_importance: int = 64
    use_disp: bool = False
    perturb: float = 1.0
    noise_std: float = 1.0
    pertube_cord: bool = False  # training only: jitter every sample point
    # by 1e-5 * U[0, 1); the points then reach the kernels one by one
    # (xyz-in) and the backward recomputes
    netdepth: int = 8
    netwidth: int = 256

    # ---- CR-NeRF head ----
    encode_a: bool = True
    encode_c: bool = False  # training: the content-constraint heads
    # (enc_cont and the un-styled decode) and their loss term
    encode_random: bool = True
    use_mask: bool = True
    mse_on_appearance: bool = False
    N_vocab: int = 1500
    nerf_out_dim: int = 64
    model_mode: str = "1-1"  # '1-1' (sigmoid) | '1-4-1' (tanh) decoder

    # ---- losses ----
    maskrs_max: float = 5e-2
    maskrs_min: float = 6e-3
    maskrs_k: float = 1e-3
    maskrd: float = 0.0
    weightKL: float = 1e-5
    weightRecA: float = 1e-3
    weightMS: float = 1e-6
    weightcontent: float = 1e-4

    # ---- sampling schedule ----
    scale_anneal: float = -1.0
    min_scale: float = 0.5

    # ---- runtime ----
    batch_size: int = 1024  # rays per grid; must be a perfect square
    grids_per_step: int = 1  # independent image grids per step
    chunk: int = 8 * 1024  # rays per render tile at inference
    num_epochs: int = 20
    num_devices: int = 0  # train / eval / video: ranks of one GPU each; 0
    # = every visible GPU with --device cuda, 1 on the CPU (under torchrun:
    # 0 or WORLD_SIZE)
    save_dir: str = "./results"
    ckpt_path: Optional[str] = None  # train: a checkpoint directory to
    # resume from; eval: weights.npz or a directory holding one
    auto_resume: bool = False  # train: resume from the exp dir's latest
    # checkpoint if one exists
    prefixes_to_ignore: Tuple[str, ...] = ("loss",)
    exp_name: str = "debug"
    proj_name: str = "crnerf_tpu"

    # ---- optimization ----
    optimizer: str = "adam"  # sgd | adam | radam | ranger
    lr: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_scheduler: str = "cosine"  # steplr | cosine | poly
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    decay_step: Tuple[int, ...] = (20,)
    decay_gamma: float = 0.1
    poly_exp: float = 0.9

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' for the MLPs
    # and convolutions
    grad_accum_chunks: int = 0  # split the G grids of a step into this many
    # sequential chunks with summed gradients; each chunk's activation stash
    # lives only from its forward to its backward. 0 = AUTO
    # (``resolved_chunks``)
    use_pallas: bool = True  # inference renders through the hand-written
    # kernels; False: the NerfMLP module, per point, then compositing
    pallas_train: bool = True  # the same choice for the training step
    pallas_render: bool = True  # where the kernels run: compositing inside
    # the fused render kernel, only per-ray results reach device memory.
    # False: the fused MLP kernel writes features and sigma per point and
    # compositing runs in plain PyTorch (under autograd in training)
    remat: bool = True  # module route, training: recompute the MLP's
    # activations in the backward (torch.utils.checkpoint), not keep them
    pallas_stash: bool = True  # training: the fused render forward keeps an
    # activation stash (about 5 KB per sample point at 8x256 bf16) for its
    # backward. False: nothing is kept and the backward recomputes the
    # forward slab by slab in a scratch of a fixed size: less memory, more
    # time
    fast_sincos: bool = True  # double-angle recurrence for the posenc
    # sweep; only consulted when compute_dtype == 'bfloat16'
    appearance_wh: Tuple[int, int] = (224, 160)  # (W, H) of the style image
    val_chunk: int = 2048  # rays per render tile in validation
    cam_rays: bool = True  # eval app: rays made on the device from the
    # camera; False: host rays
    eval_pipeline: int = 2  # eval app: frames in flight (dispatch frame
    # i+1 before fetching frame i)
    log_every: int = 50
    use_wandb: bool = False  # attach wandb to the MetricLogger when it
    # imports; metrics.jsonl is written either way
    img_panel_every: int = 5000  # train-time gt / pred / random / mask
    # panels of the step's first grid every N steps; 0 disables
    ckpt_every_epochs: int = 1
    seed: int = 42
    val_every_epochs: int = 1  # validate every N epochs (0: never); the
    # last epoch always validates when enabled
    video_format: str = "gif"  # gif | mp4 (mp4 writes the GIF with a
    # warning: no mp4 encoder without a codec package)
    num_frames: int = 0  # camera-path frames for --split test; 0 = the
    # scene preset's count (240)
    profile: bool = False  # a torch.profiler trace of training steps
    profile_steps: Tuple[int, int] = (10, 15)  # [start, stop) global steps

    def resolved_chunks(self) -> int:
        """Gradient-accumulation chunks of a step. AUTO is 1: at the
        flagship shapes all 16 grids' stash (about 5 KB per sample point)
        fits in an 80 GB card's memory with room to spare, and two chunks
        measured 18-20% slower than one on an H100
        (``tools/chunks_ab``)."""
        return self.grad_accum_chunks if self.grad_accum_chunks > 0 else 1

    @property
    def grid_hw(self) -> int:
        """Side of the sampled pixel grid: sqrt(batch_size)."""
        side = int(round(self.batch_size ** 0.5))
        if side * side != self.batch_size:
            raise ValueError(
                f"batch_size must be a perfect square (got {self.batch_size})"
            )
        return side

    @property
    def in_channels_xyz(self) -> int:
        return 6 * self.N_emb_xyz + 3

    @property
    def in_channels_dir(self) -> int:
        return 6 * self.N_emb_dir + 3

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        names = {x.name for x in dataclasses.fields(Config)}
        return Config(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items() if k in names})


# every field whose default is a bool gets a --flag / --no-flag pair
_BOOL_FIELDS = {f.name for f in dataclasses.fields(Config)
                if isinstance(getattr(Config(), f.name), bool)}


def build_parser(defaults: Optional[Config] = None
                 ) -> argparse.ArgumentParser:
    """Argparse mirror of the dataclass (``crnerf_tpu/config.py``
    ``build_parser``). Booleans get paired ``--flag`` / ``--no-flag``
    switches; tuples take ``nargs="*"``."""
    cfg = defaults or Config()
    p = argparse.ArgumentParser(description="CR-NeRF on the GPU (torch)")
    for f in dataclasses.fields(Config):
        name, default = f.name, getattr(cfg, f.name)
        arg = "--" + name
        if name in _BOOL_FIELDS:
            group = p.add_mutually_exclusive_group()
            group.add_argument(arg, dest=name, action="store_true",
                               default=default)
            group.add_argument("--no-" + name, dest=name,
                               action="store_false")
        elif isinstance(default, tuple):
            elt = type(default[0]) if default else str
            p.add_argument(arg, nargs="*", type=elt, default=list(default))
        elif default is None:
            p.add_argument(arg, type=str, default=None)
        else:
            p.add_argument(arg, type=type(default), default=default)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """The Config of parsed arguments; arguments that are not fields (an
    app's own, such as ``--device``) are left out."""
    names = {f.name for f in dataclasses.fields(Config)}
    d = {k: tuple(v) if isinstance(v, list) else v
         for k, v in vars(args).items() if k in names}
    cfg = Config(**d)
    if cfg.testit:
        cfg = cfg.replace(num_epochs=1)
    return cfg


def get_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse CLI args into a Config."""
    return config_from_args(build_parser().parse_args(argv))
