"""The port's configuration: the fields of ``crnerf_tpu/config.py``
``Config`` that the serving path reads, with the same names and defaults
(``tests/test_torch_imports.py`` holds them equal). The port keeps its own
copy so that it runs where only ``crnerf_tpu_torch/`` is present.
"""

from __future__ import annotations

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
    netdepth: int = 8
    netwidth: int = 256

    # ---- CR-NeRF head ----
    encode_a: bool = True
    use_mask: bool = True
    nerf_out_dim: int = 64
    model_mode: str = "1-1"  # '1-1' (sigmoid) | '1-4-1' (tanh) decoder

    # ---- inference ----
    chunk: int = 8 * 1024  # rays per render tile
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' for the MLPs
    # and convolutions
    fast_sincos: bool = True  # double-angle recurrence for the posenc
    # sweep; only consulted when compute_dtype == 'bfloat16'
    appearance_wh: Tuple[int, int] = (224, 160)  # (W, H) of the style image

    @property
    def in_channels_xyz(self) -> int:
        return 6 * self.N_emb_xyz + 3

    @property
    def in_channels_dir(self) -> int:
        return 6 * self.N_emb_dir + 3
