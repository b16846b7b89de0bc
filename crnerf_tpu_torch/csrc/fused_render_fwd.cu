// The forward's library: the C entry points of the fused render forward
// kernels. crnerf_render_fwd: the mma.sync kernel (fused_render_fwd.cuh,
// where it and its notes are), for inference and for the forward of
// training, rays-in and xyz-in, with or without the stash, bf16 and fp32.
// crnerf_render_fwd_wgmma: the wgmma kernel (fused_render_fwd_wgmma.cuh),
// the inference forward and the stash forward at the bf16 widths it takes.

#include "fused_render_fwd_wgmma.cuh"

// Arguments as render_fwd_entry takes them.
extern "C" int crnerf_render_fwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return render_fwd_entry(ptrs, n_ptrs, dims, n_dims, stream);
}

// Arguments as render_fwd_wgmma_entry takes them.
extern "C" int crnerf_render_fwd_wgmma(const void* const* ptrs, int n_ptrs,
                                       const int* dims, int n_dims,
                                       void* stream) {
  return render_fwd_wgmma_entry(ptrs, n_ptrs, dims, n_dims, stream);
}
