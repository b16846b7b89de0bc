// The per-point MLP forward's library: the C entry points of the fused-MLP
// forward kernels. crnerf_mlp_fwd: the mma.sync kernel (fused_mlp_fwd.cuh,
// where it and its notes are), for inference and for the forward of
// training, with or without the stash, bf16 and fp32.
// crnerf_mlp_fwd_wgmma: the wgmma kernel (fused_mlp_fwd_wgmma.cuh), the
// inference forward at the bf16 widths it takes.

#include "fused_mlp_fwd_wgmma.cuh"

// Arguments as mlp_fwd_entry takes them.
extern "C" int crnerf_mlp_fwd(const void* const* ptrs, int n_ptrs,
                              const int* dims, int n_dims, void* stream) {
  return mlp_fwd_entry(ptrs, n_ptrs, dims, n_dims, stream);
}

// Arguments as mlp_fwd_wgmma_entry takes them.
extern "C" int crnerf_mlp_fwd_wgmma(const void* const* ptrs, int n_ptrs,
                                    const int* dims, int n_dims,
                                    void* stream) {
  return mlp_fwd_wgmma_entry(ptrs, n_ptrs, dims, n_dims, stream);
}
