// Device code shared by the fused render kernels (forward and backward):
// the chunk geometry, the mma.sync / SIMT matrix products over a 64-row
// activation tile in shared memory, the scalar helpers, and the two stages
// every forward shares: the positional encode and the trunk. Included by
// every csrc/*.cu through the kernels' headers; each .cu is built into a
// library of its own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int CH = 64;          // samples per chunk = GEMM rows
constexpr int NTHREADS = 256;   // 8 warps
constexpr int PAD = 8;          // shared-memory row padding (elements)
constexpr int MAXL = 16;        // trunk layers
constexpr int MAX_NTW = 8;      // n8 tiles per warp (N <= 256)
constexpr int ANCHOR_SPAN = 8;
constexpr float DELTA_INF = 1e2f;

// ------------------------------------------------------------ matmuls
// acc += A[m0:m0+32, :K] @ B[:, nt0*8 : (nt0+ntw)*8]; A bf16 row-major in
// shared memory, B packed [kstep][ntile][lane] uint2 (see pack_mma_b).
__device__ __forceinline__ void mma_accumulate(
    float (&acc)[2][MAX_NTW][4], const __nv_bfloat16* A, int lda, int ksteps,
    const uint2* __restrict__ Wp, int nt_total, int nt0, int ntw, int m0,
    int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint2* wp = Wp + (size_t)nt0 * 32 + lane;
  uint2 bcur[MAX_NTW], bnxt[MAX_NTW];
#pragma unroll
  for (int j = 0; j < MAX_NTW; ++j) {
    bnxt[j] = make_uint2(0u, 0u);
    if (j < ntw) bcur[j] = __ldg(wp + j * 32);
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {
      const uint2* wn = wp + (size_t)(ks + 1) * nt_total * 32;
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
        if (j < ntw) bnxt[j] = __ldg(wn + j * 32);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = A + (m0 + mi * 16 + g) * lda + ks * 16 + 2 * t;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < MAX_NTW; ++j) {
      if (j < ntw) {
        mma16816(acc[0][j], af[0], bcur[j].x, bcur[j].y);
        mma16816(acc[1][j], af[1], bcur[j].x, bcur[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_NTW; ++j) bcur[j] = bnxt[j];
  }
}

// fp32: thread (rg, cg) owns rows rg*4..rg*4+3, columns 32j + 2cg + {0,1}.
__device__ __forceinline__ void simt_accumulate(
    float (&acc)[4][MAX_NTW][2], const float* A, int lda, int K,
    const float* __restrict__ W, int n_pad, int nj, int tid) {
  const int rg = tid >> 4, cg = tid & 15;
  for (int k = 0; k < K; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(rg * 4 + i) * lda + k];
    const float* wk = W + (size_t)k * n_pad + 2 * cg;
#pragma unroll
    for (int j = 0; j < MAX_NTW; ++j) {
      if (j < nj) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(wk + 32 * j));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] += a[i] * bv.x;
          acc[i][j][1] += a[i] * bv.y;
        }
      }
    }
  }
}

// out[:, :n_pad] = epi(A1 @ W1 (+ A2 @ W2)); epi(row, col, v0, v1) gets two
// adjacent columns (col even).
template <bool BF16, typename T, class Epi>
__device__ __forceinline__ void gemm(const T* A1, int lda1, int K1,
                                     const void* W1, const T* A2, int lda2,
                                     int K2, const void* W2, int n_pad,
                                     Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (BF16) {
    float acc[2][MAX_NTW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
    const int nt_total = n_pad >> 3, ntw = nt_total >> 2;
    const int m0 = (warp & 1) * 32, nt0 = (warp >> 1) * ntw;
    mma_accumulate(acc, A1, lda1, K1 >> 4, static_cast<const uint2*>(W1),
                   nt_total, nt0, ntw, m0, lane);
    if (A2 != nullptr)
      mma_accumulate(acc, A2, lda2, K2 >> 4, static_cast<const uint2*>(W2),
                     nt_total, nt0, ntw, m0, lane);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
        if (j < ntw) {
          const int row = m0 + mi * 16 + g, col = (nt0 + j) * 8 + 2 * t;
          epi(row, col, acc[mi][j][0], acc[mi][j][1]);
          epi(row + 8, col, acc[mi][j][2], acc[mi][j][3]);
        }
  } else {
    float acc[4][MAX_NTW][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
    const int nj = n_pad >> 5;
    simt_accumulate(acc, A1, lda1, K1, static_cast<const float*>(W1), n_pad,
                    nj, tid);
    if (A2 != nullptr)
      simt_accumulate(acc, A2, lda2, K2, static_cast<const float*>(W2), n_pad,
                      nj, tid);
    const int rg = tid >> 4, cg = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
        if (j < nj) epi(rg * 4 + i, 32 * j + 2 * cg, acc[i][j][0], acc[i][j][1]);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
}

template <typename T>
__device__ __forceinline__ T to_t(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

__device__ __forceinline__ float pow2f(int k) {  // exact 2^k
  return __int_as_float((127 + k) << 23);
}

// jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Rows of a shared-memory tile <-> rows of a row-major matrix in device
// memory, 16 bytes a thread. ncols * sizeof(T), both leading dimensions in
// bytes and both bases are multiples of 16.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t ld_dst, const T* src,
                                           int ld_src, int ncols, int nrows) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = ncols / VE;
  for (int i = threadIdx.x; i < nrows * vpr; i += NTHREADS) {
    const int r = i / vpr, v = (i % vpr) * VE;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld_dst + v) =
        *reinterpret_cast<const uint4*>(src + r * ld_src + v);
  }
}

// Fills all CH rows of the tile: rows past nrows are zero.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld_dst, const T* src,
                                          size_t ld_src, int ncols, int nrows) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = ncols / VE;
  for (int i = threadIdx.x; i < CH * vpr; i += NTHREADS) {
    const int r = i / vpr, v = (i % vpr) * VE;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ld_src + v));
    *reinterpret_cast<uint4*>(dst + r * ld_dst + v) = val;
  }
}

// Barrier over the NTHREADS threads of the product warps (warps 0-7).
// BAR 0 is __syncthreads(), for a CTA of those warps alone; another BAR is
// the named barrier of that id over NTHREADS threads, for a CTA whose other
// warps do other work meanwhile (pipe_render_fwd.cu).
template <int BAR>
__device__ __forceinline__ void warps_sync() {
  if constexpr (BAR == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(NTHREADS) : "memory");
  }
}

// ------------------------------------------------- encode and trunk, shared
// The positional encode of a CH-row tile, [x, sin 2^0 x, cos 2^0 x, sin 2^1
// x, ...] interleaved, into enc (CH x lde, KE columns, the ones past 3 + 6F
// zero). The caller has written the raw coordinates into xyz (CH x 3, fp32,
// shared memory) and into enc[:, :3]; every thread of the block calls this,
// and the tile is complete when it returns. sinf/cosf (accurate, never the
// fast intrinsics) of x * 2^k with exact power-of-two multipliers, or
// (exact = 0) the anchored double-angle recurrence; rounding-exact
// intrinsics keep the compiler from fusing the recurrence into FMAs the
// plain version does not use. BAR: the barrier of warps_sync.
template <typename T, int BAR = 0>
__device__ __forceinline__ void encode_tile(T* enc, int lde, const float* xyz,
                                            int F, int KE, int exact) {
  const int tid = threadIdx.x;
  for (int i = tid; i < CH * (KE - 3 - 6 * F); i += NTHREADS) {
    const int w = KE - 3 - 6 * F;
    enc[(i / w) * lde + 3 + 6 * F + i % w] = to_t<T>(0.f);
  }
  warps_sync<BAR>();
  if (exact) {
    for (int i = tid; i < CH * 3 * F; i += NTHREADS) {
      const int r = i / (3 * F), rem = i % (3 * F), k = rem / 3, c = rem % 3;
      const float arg = __fmul_rn(xyz[r * 3 + c], pow2f(k));
      T* e = enc + r * lde + 3 + 6 * k + c;
      e[0] = to_t<T>(sinf(arg));
      e[3] = to_t<T>(cosf(arg));
    }
  } else {
    const int n_anchor = (F + ANCHOR_SPAN - 1) / ANCHOR_SPAN;
    for (int i = tid; i < CH * 3 * n_anchor; i += NTHREADS) {
      const int r = i / (3 * n_anchor), rem = i % (3 * n_anchor);
      const int a0 = (rem / 3) * ANCHOR_SPAN, c = rem % 3;
      const float va = __fmul_rn(xyz[r * 3 + c], pow2f(a0));
      float s = sinf(va), co = cosf(va);
      const int k_end = min(a0 + ANCHOR_SPAN, F);
      for (int k = a0; k < k_end; ++k) {
        if (k > a0) {
          const float two_s = __fmul_rn(2.f, s);
          const float s2 = __fmul_rn(two_s, co);
          co = __fsub_rn(1.f, __fmul_rn(two_s, s));
          s = s2;
        }
        T* e = enc + r * lde + 3 + 6 * k + c;
        e[0] = to_t<T>(s);
        e[3] = to_t<T>(co);
      }
    }
  }
  warps_sync<BAR>();
}

// The trunk over a CH-row tile: h_i = relu([enc |] h_{i-1} @ W_i + b_i) at
// the compute dtype, ping-pong between act0 and act1 (CH x lda); layer 0 and
// the layers of skip_mask take the encode. With STASH every layer's output
// rows go to srow + i * WP (row stride SC). Returns the last layer's buffer;
// all threads have passed the barrier (warps_sync<BAR>) after it.
template <bool BF16, bool STASH, typename T, int BAR = 0>
__device__ __forceinline__ const T* trunk_tile(
    const T* enc, int lde, int KE, T* act0, T* act1, int lda, int WP, int L,
    int skip_mask, const void* const* wenc, const void* const* wh,
    const float* const* b, T* srow, int SC, int nrows) {
  const T* h = nullptr;
  T* bufs[2] = {act0, act1};
  for (int i = 0; i < L; ++i) {
    const bool with_enc = i == 0 || ((skip_mask >> i) & 1);
    T* out = bufs[i & 1];
    const float* bias = b[i];
    auto epi = [&](int r, int c, float v0, float v1) {
      store2<T>(out + r * lda + c, fmaxf(v0 + bias[c], 0.f),
                fmaxf(v1 + bias[c + 1], 0.f));
    };
    if (i == 0) {
      gemm<BF16, T>(enc, lde, KE, wenc[0], (const T*)nullptr, 0, 0, nullptr,
                    WP, epi);
    } else if (with_enc) {
      gemm<BF16, T>(enc, lde, KE, wenc[i], h, lda, WP, wh[i], WP, epi);
    } else {
      gemm<BF16, T>(h, lda, WP, wh[i], (const T*)nullptr, 0, 0, nullptr, WP,
                    epi);
    }
    warps_sync<BAR>();
    if constexpr (STASH) store_rows<T>(srow + i * WP, SC, out, lda, WP, nrows);
    h = out;
  }
  return h;
}

}  // namespace
