"""Host-side data: the synthetic scene, the flat ray buffers, the grid
sampler and the batch pipeline (numpy)."""
