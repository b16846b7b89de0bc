// The stash backward's library: the C entry points of the two backward
// kernels (fused_render_bwd.cuh, where the kernels and their notes are) on a
// stash that the forward kept for the whole batch, and of the chain's wgmma
// counterpart (fused_render_bwd_wgmma.cuh) at the bf16 shape it takes.

#include "fused_render_bwd_wgmma.cuh"

// Arguments as render_bwd_chain_entry takes them.
extern "C" int crnerf_render_bwd_chain(const void* const* ptrs, int n_ptrs,
                                       const int* dims, int n_dims,
                                       void* stream) {
  return render_bwd_chain_entry(ptrs, n_ptrs, dims, n_dims, stream, false);
}

// Arguments as render_bwd_wgrad_entry takes them.
extern "C" int crnerf_render_bwd_wgrad(const void* const* ptrs, int n_ptrs,
                                       const int* dims, int n_dims,
                                       void* stream) {
  return render_bwd_wgrad_entry(ptrs, n_ptrs, dims, n_dims, stream, false);
}

// Arguments as render_bwd_chain_wgmma_entry takes them.
extern "C" int crnerf_render_bwd_chain_wgmma(const void* const* ptrs,
                                             int n_ptrs, const int* dims,
                                             int n_dims, void* stream) {
  return render_bwd_chain_wgmma_entry(ptrs, n_ptrs, dims, n_dims, stream,
                                      false);
}
