// Encode-block assembly before one product: each tile of x, (8, T = 512)
// f32, becomes a (96, 512) block, and the tile's output is blk^T @ w,
// (512, 256) f32, with bf16 operands and fp32 accumulation. Three modes:
//   base    (0): rows 0-7 = x, rows 8-95 zero;
//   stores  (1): 15 double-angle steps s, c <- 2sc, 1 - 2s^2 on the (3, T)
//                pieces s = x[0:3], c = x[3:6]; after step k (0-based) s in
//                rows 3k..3k+2 (0-44), c in rows 45+3k..47+3k (45-89);
//                x[0:3] in rows 90-92, rows 93-95 zero;
//   dmatrix (2): sin(D x), D[r, k] = 0.01 r for all k: row r is
//                sinf(sum_k (0.01 r) x[k, t]), the sum in fp32 over k in
//                order, each product and sum rounded (as the plain version
//                takes them).
//
// Replaces the Pallas TPU kernel of scripts/spike_sublane_stores.py:40 (the
// kernel inside run, called at :70), which asks whether storing (3, T)
// pieces at 3-row offsets of a VMEM block costs the TPU anything beside
// the product. The TPU kernel leaves the block's unset rows as whatever its
// scratch held (rows 8-95 in base, 93-95 in stores); here they are zero.
// The TPU's dmatrix product runs at the default precision (bf16 passes);
// here its sum is fp32.
//
// Rounding: the recurrence goes through __fmul_rn / __fsub_rn, two roundings
// a product as the plain version's elementwise ops take them. Each step can
// double a difference of an ulp (2^15 over 15 steps), so an FMA the plain
// version does not have would show. The recurrence is stable only on real
// (sin t, cos t) pairs; on other inputs (the spike's N(0, 1) x) it
// overflows to inf / NaN, here and in the plain version alike.
//
// What bounds it, on an H100 SXM: the output's bytes. A tile writes 512
// KiB of f32 and reads 16 KiB of x: 0.161 us at 3.35 TB/s, against 25.2
// MFLOP of product (0.025 us at the bf16 peak). Design: one CTA per 64
// columns of a tile (8 CTAs a tile); it loads its (8, 64) piece of x,
// builds the (64 x 96) transposed bf16 block in shared memory row by row,
// runs the product on mma.sync m16n8k16 (gemm of fused_render_common.cuh,
// w packed in fragment order and read from L2, 48 KB), stages the (64,
// 256) f32 result in shared memory and writes it as one contiguous 64 KB
// run of float4 stores.

#include "fused_render_common.cuh"

namespace {

constexpr int SS_T = 512;              // columns of a tile
constexpr int SS_ROWS = 96;            // rows of the block
constexpr int SS_N = 256;              // columns of w and of the output
constexpr int SS_LDA = SS_ROWS + PAD;  // bf16 row stride of the block
constexpr int SS_LDO = SS_N + 8;       // f32 row stride of the staging
constexpr int SS_STEPS = 15;

constexpr size_t ss_smem_bytes() {
  return (size_t)CH * SS_LDA * 2 + (size_t)8 * CH * 4 +
         (size_t)CH * SS_LDO * 4;
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
    sublane_stores_kernel(const float* __restrict__ x,
                          const void* __restrict__ wp,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);  // A[t][r]
  float* xs = reinterpret_cast<float*>(A + CH * SS_LDA);       // xs[k][t]
  float* stage = xs + 8 * CH;                                   // (CH, N)
  const int tid = threadIdx.x;
  const int tile = blockIdx.x / (SS_T / CH);
  const int t0 = (blockIdx.x % (SS_T / CH)) * CH;

  for (int i = tid; i < 8 * CH; i += NTHREADS) {
    const int k = i / CH, t = i % CH;
    xs[i] = x[((size_t)tile * 8 + k) * SS_T + t0 + t];
  }
  __syncthreads();
  if constexpr (MODE == 1) {
    for (int i = tid; i < CH * 3; i += NTHREADS) {
      const int t = i / 3, j = i % 3;
      __nv_bfloat16* row = A + t * SS_LDA;
      float s = xs[j * CH + t], c = xs[(3 + j) * CH + t];
      for (int k = 0; k < SS_STEPS; ++k) {
        const float two_s = __fmul_rn(2.f, s);
        const float s2 = __fmul_rn(two_s, c);
        c = __fsub_rn(1.f, __fmul_rn(two_s, s));
        s = s2;
        row[3 * k + j] = __float2bfloat16_rn(s);
        row[45 + 3 * k + j] = __float2bfloat16_rn(c);
      }
      row[90 + j] = __float2bfloat16_rn(xs[j * CH + t]);
      row[93 + j] = __float2bfloat16_rn(0.f);
    }
  } else {
    for (int i = tid; i < CH * SS_ROWS; i += NTHREADS) {
      const int t = i / SS_ROWS, r = i % SS_ROWS;
      float v;
      if constexpr (MODE == 0) {
        v = r < 8 ? xs[r * CH + t] : 0.f;
      } else {
        const float dr = __fmul_rn((float)r, 0.01f);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(dr, xs[k * CH + t]));
        v = sinf(acc);
      }
      A[t * SS_LDA + r] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
  auto epi = [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(stage + r * SS_LDO + c) = make_float2(v0, v1);
  };
  gemm<true, __nv_bfloat16>(A, SS_LDA, SS_ROWS, wp,
                            (const __nv_bfloat16*)nullptr, 0, 0, nullptr,
                            SS_N, epi);
  __syncthreads();
  float* orow = out + ((size_t)tile * SS_T + t0) * SS_N;
  for (int i = tid; i < CH * SS_N / 4; i += NTHREADS) {
    const int r = i / (SS_N / 4), c4 = (i % (SS_N / 4)) * 4;
    *reinterpret_cast<float4*>(orow + (size_t)r * SS_N + c4) =
        *reinterpret_cast<const float4*>(stage + r * SS_LDO + c4);
  }
}

template <int MODE>
int launch(const float* x, const void* wp, float* out, int tiles,
           cudaStream_t st) {
  const size_t smem = ss_smem_bytes();
  cudaFuncSetAttribute(sublane_stores_kernel<MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  sublane_stores_kernel<MODE>
      <<<tiles * (SS_T / CH), NTHREADS, smem, st>>>(x, wp, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs (host array): x (tiles * 8, 512) f32, w packed by pack_mma_b from
// (96, 256) (bf16), out (tiles * 512, 256) f32. mode: 0 base, 1 stores,
// 2 dmatrix. Launches on ``stream``; returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int crnerf_sublane_stores(const void* const* ptrs, int n_ptrs,
                                     int tiles, int mode, void* stream) {
  if (n_ptrs != 3 || tiles < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)ptrs[0];
  float* out = (float*)ptrs[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch<0>(x, ptrs[1], out, tiles, st);
  if (mode == 1) return launch<1>(x, ptrs[1], out, tiles, st);
  return launch<2>(x, ptrs[1], out, tiles, st);
}
