"""Host-side data: the synthetic scene, the phototourism loader and its npz
cache, the COLMAP and PFM readers, the flat ray buffers, the grid sampler
and the batch pipeline (numpy)."""
