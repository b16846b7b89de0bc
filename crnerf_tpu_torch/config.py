"""The port's configuration: the fields of ``crnerf_tpu/config.py``
``Config`` that the serving path and the training step read, with the same
names and defaults (``tests/test_torch_imports.py`` holds them equal). The
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

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass
class Config:
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
    encode_c: bool = False  # the content-constraint heads are not ported
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

    # ---- runtime ----
    batch_size: int = 1024  # rays per grid; must be a perfect square
    grids_per_step: int = 1  # independent image grids per step
    chunk: int = 8 * 1024  # rays per render tile at inference
    num_epochs: int = 20

    # ---- optimization ----
    optimizer: str = "adam"  # sgd | adam (radam and ranger are not ported)
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
    seed: int = 42

    def __post_init__(self):
        if self.encode_c:
            raise ValueError("encode_c=True: the content-constraint heads "
                             "are not ported")
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer {self.optimizer!r} is not ported "
                             "(adam, sgd)")

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
