// Deterministic alpha compositing of per-sample features along rays:
// features (N, S, C), sigma (N, S), z (N, S), all f32 -> weights (N, S),
// feature map (N, C), depth (N). sigma is clamped at 0, the last delta is
// 1e2, alpha = 1 - exp(-delta * sigma), weights = alpha * exclusive running
// product of (1 - alpha), outputs are the weighted sums. No noise and no
// gradient (the fused render kernels composite inside themselves; this is
// the stand-alone op).
//
// Replaces crnerf_tpu/ops/composite.py:_composite_kernel (the Pallas TPU
// kernel behind composite_pallas). That kernel pads S and C to 128 lanes,
// takes the running product by log-doubling shifts of a whole (rays, S)
// block and sums the features in 32-sample chunks; a GPU warp scans.
//
// What bounds it: bytes. One multiply-add per feature value read, so the
// feature read (N * S * C * 4 bytes) is all of the time. Design: one warp
// per ray. It walks the ray 32 samples at a time: lane j takes sample j's
// alpha, a shuffle scan gives the transmittance inside the 32 and a running
// product carries it across, the weight is written, then the warp reads the
// 32 samples' features row by row, lane c on channel c (coalesced along C,
// each value read exactly once), and every lane keeps the sums of its
// channels in registers. No padding of S or C and nothing staged in shared
// memory. C <= 256 (8 channels a lane).
// Left for later: 16-byte loads when C is a multiple of 4, several warps
// on one ray when S * C is large and N small.

#include <cuda_runtime.h>

namespace {

constexpr float DELTA_INF = 1e2f;
constexpr int WARPS = 4;      // rays per block

template <int NC>             // channels per lane: C <= 32 * NC
__global__ void __launch_bounds__(32 * WARPS)
    composite_kernel(const float* __restrict__ feat,
                     const float* __restrict__ sigma,
                     const float* __restrict__ z, float* __restrict__ w_out,
                     float* __restrict__ fmap, float* __restrict__ depth,
                     int N, int S, int C) {
  const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ray >= N) return;       // the whole warp leaves together
  const float* f = feat + (size_t)ray * S * C;
  const float* sg = sigma + (size_t)ray * S;
  const float* zr = z + (size_t)ray * S;
  float* wo = w_out + (size_t)ray * S;
  float acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) acc[k] = 0.f;
  float t_carry = 1.f;        // transmittance entering these 32 samples
  float dep = 0.f;

  for (int s0 = 0; s0 < S; s0 += 32) {
    const int j = s0 + lane;
    float alpha = 0.f, zj = 0.f;
    if (j < S) {
      zj = zr[j];
      const float delta = j < S - 1 ? zr[j + 1] - zj : DELTA_INF;
      alpha = 1.f - expf(-delta * fmaxf(sg[j], 0.f));
    }
    float incl = 1.f - alpha;   // inclusive running product over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl *= y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 1.f;
    const float w = alpha * (t_carry * excl);
    t_carry *= __shfl_sync(0xffffffffu, incl, 31);
    if (j < S) wo[j] = w;
    dep += w * zj;
    // the 32 samples' weighted features first, then onto the ray's sums:
    // no sum runs over more than 32 + S/32 terms, which keeps the feature
    // map within ~1e-6 of a float64 sum at S = 512
    const int nj = min(32, S - s0);
    float part[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) part[k] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < nj; ++jj) {
      const float wj = __shfl_sync(0xffffffffu, w, jj);
      const float* fr = f + (size_t)(s0 + jj) * C;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = lane + 32 * k;
        if (c < C) part[k] += wj * fr[c];
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] += part[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dep += __shfl_xor_sync(0xffffffffu, dep, off);
  if (lane == 0) depth[ray] = dep;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < C) fmap[(size_t)ray * C + c] = acc[k];
  }
}

}  // namespace

// ptrs (host array): features, sigma, z, weights out, feature map out,
// depth out. dims: N, S, C. Launches on ``stream`` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int crnerf_composite(const void* const* ptrs, int n_ptrs,
                                const int* dims, int n_dims, void* stream) {
  if (n_ptrs != 6 || n_dims != 3) return (int)cudaErrorInvalidValue;
  const int N = dims[0], S = dims[1], C = dims[2];
  if (N < 1 || S < 1 || C < 1 || C > 256) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const float* feat = (const float*)ptrs[0];
  const float* sigma = (const float*)ptrs[1];
  const float* z = (const float*)ptrs[2];
  float* w_out = (float*)ptrs[3];
  float* fmap = (float*)ptrs[4];
  float* depth = (float*)ptrs[5];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + WARPS - 1) / WARPS;
  const int nc = (C + 31) / 32;
#define CRNERF_COMPOSITE(NC)                                              \
  composite_kernel<NC><<<blocks, 32 * WARPS, 0, st>>>(feat, sigma, z,     \
                                                      w_out, fmap, depth, \
                                                      N, S, C)
  if (nc <= 1) CRNERF_COMPOSITE(1);
  else if (nc <= 2) CRNERF_COMPOSITE(2);
  else if (nc <= 4) CRNERF_COMPOSITE(4);
  else CRNERF_COMPOSITE(8);
#undef CRNERF_COMPOSITE
  return (int)cudaGetLastError();
}
