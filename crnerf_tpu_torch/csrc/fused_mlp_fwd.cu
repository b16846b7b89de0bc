// The per-point MLP forward's library: the C entry point of the fused-MLP
// forward kernel (fused_mlp_fwd.cuh, where the kernel and its notes are),
// for inference and for the forward of training, with or without the stash.

#include "fused_mlp_fwd.cuh"

// Arguments as mlp_fwd_entry takes them.
extern "C" int crnerf_mlp_fwd(const void* const* ptrs, int n_ptrs,
                              const int* dims, int n_dims, void* stream) {
  return mlp_fwd_entry(ptrs, n_ptrs, dims, n_dims, stream);
}
