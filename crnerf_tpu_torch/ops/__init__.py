"""Hand-written CUDA kernels and their plain PyTorch versions:
``fused_render`` (encode + NeRF MLP + compositing of one pass, forward and
both backwards), ``fused_mlp`` (encode + NeRF MLP per sample point, forward
and backward), ``composite`` (alpha compositing alone), and the kernels of
the spike tools, on no path of the system: ``conv`` (3x3 and packed 2x2
conv forwards, 3x3 weight gradient) and ``sincos``."""

from crnerf_tpu_torch.ops.composite import composite_apply  # noqa: F401
from crnerf_tpu_torch.ops.fused_mlp import (  # noqa: F401
    fused_mlp_apply,
    fused_mlp_train,
)
