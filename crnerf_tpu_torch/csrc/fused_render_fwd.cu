// The forward's library: the C entry point of the fused render forward
// kernel (fused_render_fwd.cuh, where the kernel and its notes are), for
// inference and for the forward of training, rays-in and xyz-in, with or
// without the stash.

#include "fused_render_fwd.cuh"

// Arguments as render_fwd_entry takes them.
extern "C" int crnerf_render_fwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  return render_fwd_entry(ptrs, n_ptrs, dims, n_dims, stream);
}
