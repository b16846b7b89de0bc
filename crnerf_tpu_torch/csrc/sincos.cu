// Elementwise sin and cos of an fp32 array: s = sin(x), c = cos(x).
//
// Replaces the Pallas TPU kernel of scripts/spike_kernel_sincos.py:24 (the
// kernel inside main, called at :34), which asks whether the TPU's
// in-kernel sin/cos are accurate at the positional encode's anchor scales
// (|x| <= 5, 80, 1280, 10,240 and 81,920 rad). The question on this card
// is what the port's own CUDA kernels compute, so the accurate variant
// goes through the same sinf / cosf (never the fast intrinsics; the
// libraries are built without --use_fast_math) that encode_tile in
// fused_render_common.cuh evaluates. FAST = true gives __sinf / __cosf,
// the hardware's approximations, as a second variant to report; no kernel
// of the port uses them.
//
// What bounds it, on an H100 SXM: bytes, 12 a value (x read once, s and c
// written once): 1.5 MB at the spike's (1024, 128), 0.47 us at 3.35 TB/s,
// far below a launch's own cost. sinf's slow path (Payne-Hanek reduction
// past |x| ~ 1e5) is not reached at these scales. Design: a grid-stride
// loop, one value a thread an iteration, coalesced.

#include <cuda_runtime.h>

namespace {

template <bool FAST>
__global__ void sincos_kernel(const float* __restrict__ x,
                              float* __restrict__ s, float* __restrict__ c,
                              long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    if constexpr (FAST) {
      s[i] = __sinf(v);
      c[i] = __cosf(v);
    } else {
      s[i] = sinf(v);
      c[i] = cosf(v);
    }
  }
}

}  // namespace

// ptrs (host array): x, s out, c out, all fp32 of ``n`` values; fast != 0
// takes the intrinsics. Launches on ``stream``; returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int crnerf_sincos(const void* const* ptrs, int n_ptrs,
                             long long n, int fast, void* stream) {
  if (n_ptrs != 3 || n < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)ptrs[0];
  float* s = (float*)ptrs[1];
  float* c = (float*)ptrs[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (fast)
    sincos_kernel<true><<<blocks, 256, 0, st>>>(x, s, c, n);
  else
    sincos_kernel<false><<<blocks, 256, 0, st>>>(x, s, c, n);
  return (int)cudaGetLastError();
}
