// The stash backward's library: the C entry points of the two backward
// kernels (fused_render_bwd.cuh, where the kernels and their notes are) on a
// stash that the forward kept for the whole batch, of the chain's wgmma
// counterpart (fused_render_bwd_wgmma.cuh) at the bf16 shape it takes, and
// of the weight gradient, whichever kernel it names (wgrad_wgmma.cuh).

#include "fused_render_bwd_wgmma.cuh"

// Arguments as render_bwd_chain_entry takes them.
extern "C" int crnerf_render_bwd_chain(const void* const* ptrs, int n_ptrs,
                                       const int* dims, int n_dims,
                                       void* stream) {
  return render_bwd_chain_entry(ptrs, n_ptrs, dims, n_dims, stream, false);
}

// Arguments as render_bwd_wgrad_entry takes them, and after its dims one
// more: 1 to add the sums onto what wout holds (accumulate), 0 to write
// them.
extern "C" int crnerf_render_bwd_wgrad(const void* const* ptrs, int n_ptrs,
                                       const int* dims, int n_dims,
                                       void* stream) {
  if (n_dims != WGRAD_DIMS + 1) return (int)cudaErrorInvalidValue;
  return render_bwd_wgrad_entry(ptrs, n_ptrs, dims, WGRAD_DIMS, stream,
                                dims[WGRAD_DIMS] != 0);
}

// Arguments as render_bwd_chain_wgmma_entry takes them.
extern "C" int crnerf_render_bwd_chain_wgmma(const void* const* ptrs,
                                             int n_ptrs, const int* dims,
                                             int n_dims, void* stream) {
  return render_bwd_chain_wgmma_entry(ptrs, n_ptrs, dims, n_dims, stream,
                                      false);
}
