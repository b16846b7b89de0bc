"""Host-side data: the synthetic scene, the phototourism loader and its npz
cache, the Blender loader, the COLMAP and PFM readers, the flat ray
buffers, the grid sampler and the batch pipeline (numpy)."""

from crnerf_tpu_torch.data.blender import (  # noqa: F401
    add_perturbation,
    load_blender,
)
