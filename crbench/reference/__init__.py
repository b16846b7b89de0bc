"""The plain reference of CR-NeRF that decides ``correct``: the system's
forward, losses, backward and Adam (``train.py``) and a served frame
(``frame.py``) in float32 PyTorch operators, with TF32 off, over named
weight tensors that the benchmark makes. It imports nothing of
``crnerf_tpu_torch`` nor of the JAX package, and reads nothing the
program made: the benchmark hands it the seeded weights, the scene, the
cameras and the random draws, and it works out rays, samples, masks,
embeddings and caches itself.

The arithmetic follows the published CR-NeRF (arXiv 2307.08093) as the
JAX package and its port state it: NeRF's 8x256 trunk with the encode fed
in again at layer 4, a softplus density and a sigmoid feature head, alpha
compositing with the last interval 1e2 long, inverse-CDF resampling, the
VGG-style appearance encoder, the StyleNet transform and decoder, the
CGNet mask with each image normalised by its own statistics in training,
and the CR-NeRF loss terms. ``Quant`` turns every product's operands
into fp8 (e4m3) for the control.
"""
