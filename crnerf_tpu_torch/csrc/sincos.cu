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
// far below a launch's own cost; so what a call costs is the launch and
// the host's path to it (its wrapper binds this entry once and passes its
// pointers as arguments, not through an array). sinf's slow path
// (Payne-Hanek reduction past |x| ~ 1e5) is not reached at these scales.
// Design: a grid-stride loop, one value a thread an iteration, coalesced.
// (Four values a thread with 16-byte loads and stores, one wave over the
// SMs, was slower on an H100 at (1024, 128): too few threads in flight to
// hide sinf's latency.)

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

// x, s out, c out, all fp32 of ``n`` values; fast != 0 takes the
// intrinsics. Launches on ``stream``; returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int crnerf_sincos(const void* x, void* s, void* c, long long n,
                             int fast, void* stream) {
  if (n < 1 || !x || !s || !c) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(s);
  float* cf = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (fast)
    sincos_kernel<true><<<blocks, 256, 0, st>>>(xf, sf, cf, n);
  else
    sincos_kernel<false><<<blocks, 256, 0, st>>>(xf, sf, cf, n);
  return (int)cudaGetLastError();
}
