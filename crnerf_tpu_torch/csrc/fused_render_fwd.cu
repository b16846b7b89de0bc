// Fused volume rendering forward for one pass, rays-in mode: xyz = o + d*z,
// positional encode, NeRF MLP (trunk with skip, sigma / final / dir /
// feature heads) and alpha compositing in ONE kernel. Only per-ray results
// leave it: ray block [feature map | depth | 0] (N, ldo) f32 and weights
// (N, S) f32.
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_fwd_kernel (the
// Pallas TPU kernel, forward, rays_in=True, stash=False).
//
// What bounds it: ~1.2 MFLOP of matrix products per sample point at 8x256
// (11 products, ~0.6 M multiply-adds) against ~8 bytes of per-ray input
// per point, so the tensor cores bound it, not device memory. Design:
//   * One CTA (8 warps) per ray. It walks the ray in chunks of CH = 64
//     consecutive samples and carries the transmittance from chunk to
//     chunk as a running product (the TPU kernel's whole-row log-doubling
//     cumprod and iota-mask matmuls are a TPU layout device; a GPU scans).
//   * Per chunk the encode and every activation stay in shared memory
//     (64 x 256 bf16 = 32 KB per buffer, two buffers ping-pong); only the
//     feature block (64 x C f32) and the per-row scalars sit beside them.
//   * bf16: every layer is mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//     each warp owns a 32-row x N/4 tile. Weights are read from global
//     memory (1.2 MB of bf16 stays resident in the 50 MB L2), pre-packed
//     by the wrapper in fragment order so one warp reads a 16x8 tile as
//     256 contiguous bytes; the next k-step's fragments are loaded while
//     the current ones multiply.
//   * fp32: the same schedule with fp32 FMA (SIMT) products.
//   * The dir term (dir encode @ W_dir_enc) is computed once per ray.
//   * Dtype policy as the JAX kernel's _mlp_fwd: ReLU outputs, hf and dd
//     cast to the compute dtype; the sigma head at the compute dtype with
//     fp32 accumulation; biases, softplus, sigmoid and compositing fp32.
//   * Encode: sinf/cosf (accurate, never the fast intrinsics) of x * 2^k
//     with exact power-of-two multipliers, or the anchored double-angle
//     recurrence; rounding-exact intrinsics keep the compiler from fusing
//     the recurrence and o + d*z into FMAs the plain version does not use.
// Left for later: wgmma, TMA, persistent CTAs, several rays per CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CH = 64;          // samples per chunk = GEMM rows
constexpr int NTHREADS = 256;   // 8 warps
constexpr int PAD = 8;          // shared-memory row padding (elements)
constexpr int MAXL = 16;        // trunk layers
constexpr int MAX_NTW = 8;      // n8 tiles per warp (N <= 256)
constexpr int ANCHOR_SPAN = 8;
constexpr float DELTA_INF = 1e2f;

struct KArgs {
  const float* od;      // (N, 8) [o | d | pad]
  const float* z;       // (N, S)
  const float* noise;   // (N, S)
  const float* dirb;    // (N, DK) dir encode at the compute dtype
  float* out;           // (N, ldo)
  float* wout;          // (N, S)
  const void* ws; const float* bs;    // sigma head (WP x 32)
  const void* wf; const float* bf;    // xyz_encoding_final (WP x WP)
  const void* wdh; const float* bd;   // dir_encoding, hidden rows (WP x HP)
  const float* wde;                   // dir_encoding, encode rows (DK x HP)
  const void* wc; const float* bc;    // feature head (HP x CP)
  const void* wenc[MAXL];             // encode rows of layer i (KE x WP)
  const void* wh[MAXL];               // hidden rows of layer i (WP x WP)
  const float* b[MAXL];
  int N, S, L, skip_mask, WP, HP, CP, C, KE, F, DK, exact, ldo;
};

// ------------------------------------------------------------ matmuls
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ float pow2f(int k) {  // exact 2^k
  return __int_as_float((127 + k) << 23);
}

// jax.nn.softplus: max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// ------------------------------------------------------------- kernel
template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, BF16 ? 2 : 1)
    render_fwd_kernel(const KArgs a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray = blockIdx.x;
  const int S = a.S, F = a.F;
  const int lde = a.KE + PAD, lda = a.WP + PAD;

  T* enc = reinterpret_cast<T*>(smem);
  T* act0 = enc + CH * lde;
  T* act1 = act0 + CH * lda;
  float* feat = reinterpret_cast<float*>(act1 + CH * lda);
  float* sig = feat + CH * a.CP;
  float* zc = sig + CH;
  float* nz = zc + CH;
  float* dl = nz + CH;
  float* wts = dl + CH;
  float* xyz = wts + CH;       // CH * 3
  float* dirt = xyz + CH * 3;  // HP

  const float* od = a.od + (size_t)ray * 8;
  const float o[3] = {od[0], od[1], od[2]};
  const float d[3] = {od[3], od[4], od[5]};
  const float* zr = a.z + (size_t)ray * S;
  const float* nr = a.noise + (size_t)ray * S;

  // dir term, once per ray: dir encode @ W_dir_enc (fp32 accumulation of
  // compute-dtype operands)
  for (int n = tid; n < a.HP; n += NTHREADS) {
    const float* db = a.dirb + (size_t)ray * a.DK;
    float s = 0.f;
    for (int e = 0; e < a.DK; ++e) s += db[e] * a.wde[e * a.HP + n];
    dirt[n] = s;
  }

  float t_carry = 1.f;  // transmittance entering the chunk (warp 0)
  float dep = 0.f;      // depth accumulator (warp 0)
  float fm = 0.f;       // feature-map accumulator of channel tid (tid < C)

  for (int c0 = 0; c0 < S; c0 += CH) {
    // per-row scalars; rows past S repeat the last sample and get alpha 0
    if (tid < CH) {
      const int j = c0 + tid;
      const int jc = j < S ? j : S - 1;
      const float zj = zr[jc];
      zc[tid] = zj;
      nz[tid] = j < S ? nr[j] : 0.f;
      dl[tid] = j < S - 1 ? zr[j + 1] - zj : DELTA_INF;
    }
    __syncthreads();
    // encode: [x, sin 2^0 x, cos 2^0 x, sin 2^1 x, ...] interleaved
    for (int i = tid; i < CH * 3; i += NTHREADS) {
      const int r = i / 3, c = i % 3;
      const float x = __fadd_rn(o[c], __fmul_rn(d[c], zc[r]));
      xyz[i] = x;
      enc[r * lde + c] = to_t<T>(x);
    }
    for (int i = tid; i < CH * (a.KE - 3 - 6 * F); i += NTHREADS) {
      const int w = a.KE - 3 - 6 * F;
      enc[(i / w) * lde + 3 + 6 * F + i % w] = to_t<T>(0.f);
    }
    __syncthreads();
    if (a.exact) {
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
    __syncthreads();

    // trunk
    const T* h = nullptr;
    T* bufs[2] = {act0, act1};
    for (int i = 0; i < a.L; ++i) {
      const bool with_enc = i == 0 || ((a.skip_mask >> i) & 1);
      T* out = bufs[i & 1];
      const float* bias = a.b[i];
      auto epi = [&](int r, int c, float v0, float v1) {
        store2<T>(out + r * lda + c, fmaxf(v0 + bias[c], 0.f),
                  fmaxf(v1 + bias[c + 1], 0.f));
      };
      if (i == 0) {
        gemm<BF16, T>(enc, lde, a.KE, a.wenc[0], (const T*)nullptr, 0, 0,
                      nullptr, a.WP, epi);
      } else if (with_enc) {
        gemm<BF16, T>(enc, lde, a.KE, a.wenc[i], h, lda, a.WP, a.wh[i], a.WP,
                      epi);
      } else {
        gemm<BF16, T>(h, lda, a.WP, a.wh[i], (const T*)nullptr, 0, 0, nullptr,
                      a.WP, epi);
      }
      __syncthreads();
      h = out;
    }
    T* spare = (h == act0) ? act1 : act0;
    // sigma head (column 0 of a 32-wide product) and xyz_encoding_final
    {
      const float* bs = a.bs;
      auto epi_s = [&](int r, int c, float v0, float) {
        if (c == 0) sig[r] = v0 + bs[0];
      };
      gemm<BF16, T>(h, lda, a.WP, a.ws, (const T*)nullptr, 0, 0, nullptr, 32,
                    epi_s);
      const float* bf = a.bf;
      auto epi_f = [&](int r, int c, float v0, float v1) {
        store2<T>(spare + r * lda + c, v0 + bf[c], v1 + bf[c + 1]);
      };
      gemm<BF16, T>(h, lda, a.WP, a.wf, (const T*)nullptr, 0, 0, nullptr,
                    a.WP, epi_f);
    }
    __syncthreads();
    // dir branch: relu(hf @ W_dh + dir term + b_d) into the trunk buffer
    {
      T* ddb = const_cast<T*>(h);
      const float* bd = a.bd;
      auto epi_d = [&](int r, int c, float v0, float v1) {
        store2<T>(ddb + r * lda + c, fmaxf(v0 + dirt[c] + bd[c], 0.f),
                  fmaxf(v1 + dirt[c + 1] + bd[c + 1], 0.f));
      };
      gemm<BF16, T>(spare, lda, a.WP, a.wdh, (const T*)nullptr, 0, 0, nullptr,
                    a.HP, epi_d);
    }
    __syncthreads();
    // feature head: sigmoid(dd @ W_c + b_c), fp32
    {
      const float* bc = a.bc;
      const int cp = a.CP;
      auto epi_c = [&](int r, int c, float v0, float v1) {
        feat[r * cp + c] = 1.f / (1.f + expf(-(v0 + bc[c])));
        feat[r * cp + c + 1] = 1.f / (1.f + expf(-(v1 + bc[c + 1])));
      };
      gemm<BF16, T>(h, lda, a.HP, a.wc, (const T*)nullptr, 0, 0, nullptr,
                    a.CP, epi_c);
    }
    __syncthreads();

    // compositing of the chunk: warp 0, two rows per lane
    if (warp == 0) {
      float al[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 2 * lane + q;
        const float act = fmaxf(softplusf(sig[r]) + nz[r], 0.f);
        al[q] = (c0 + r < S) ? 1.f - expf(-dl[r] * act) : 0.f;
      }
      float incl = (1.f - al[0]) * (1.f - al[1]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl *= y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 1.f;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      const float t0 = t_carry * excl;
      const float w0 = al[0] * t0;
      const float w1 = al[1] * (t0 * (1.f - al[0]));
      t_carry *= total;
      const int r0 = 2 * lane;
      wts[r0] = w0;
      wts[r0 + 1] = w1;
      float* wo = a.wout + (size_t)ray * S;
      if (c0 + r0 < S) wo[c0 + r0] = w0;
      if (c0 + r0 + 1 < S) wo[c0 + r0 + 1] = w1;
      float pd = w0 * zc[r0] + w1 * zc[r0 + 1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        pd += __shfl_xor_sync(0xffffffffu, pd, off);
      dep += pd;
    }
    __syncthreads();
    if (tid < a.C) {
      for (int r = 0; r < CH; ++r) fm += wts[r] * feat[r * a.CP + tid];
    }
  }
  float* orow = a.out + (size_t)ray * a.ldo;
  for (int c = tid; c < a.ldo; c += NTHREADS) {
    if (c < a.C) orow[c] = fm;
    else if (c != a.C) orow[c] = 0.f;
  }
  if (tid == 0) orow[a.C] = dep;
}

size_t smem_bytes(const KArgs& a, bool bf16) {
  const size_t esz = bf16 ? 2 : 4;
  const size_t t_elems =
      (size_t)CH * (a.KE + PAD) + 2 * (size_t)CH * (a.WP + PAD);
  const size_t f_elems = (size_t)CH * a.CP + 5 * CH + 3 * CH + a.HP;
  return t_elems * esz + f_elems * 4;
}

}  // namespace

// ptrs (host array): od, z, noise, dirb, out, wout, ws, bs, wf, bf, wdh, bd,
// wde, wc, bc, then per trunk layer (wenc, wh, b); absent operands are 0.
// dims: N, S, L, skip_mask, WP, HP, CP, C, KE, F, DK, exact, ldo, BF16.
// Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int crnerf_render_fwd(const void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream) {
  if (n_dims != 14) return (int)cudaErrorInvalidValue;
  KArgs a = {};
  a.N = dims[0]; a.S = dims[1]; a.L = dims[2]; a.skip_mask = dims[3];
  a.WP = dims[4]; a.HP = dims[5]; a.CP = dims[6]; a.C = dims[7];
  a.KE = dims[8]; a.F = dims[9]; a.DK = dims[10]; a.exact = dims[11];
  a.ldo = dims[12];
  const bool bf16 = dims[13] != 0;
  if (a.N < 1 || a.S < 1 || a.L < 1 || a.L > MAXL) return (int)cudaErrorInvalidValue;
  if (n_ptrs != 15 + 3 * a.L) return (int)cudaErrorInvalidValue;
  if (a.WP % 32 || a.WP > 32 * MAX_NTW || a.HP % 32 || a.HP > a.WP ||
      a.CP % 32 || a.CP > 32 * MAX_NTW || a.C > a.CP || a.C >= a.ldo ||
      a.KE % 16 || a.KE < 3 + 6 * a.F || a.F < 1 || a.F > 30)
    return (int)cudaErrorInvalidValue;
  a.od = (const float*)ptrs[0]; a.z = (const float*)ptrs[1];
  a.noise = (const float*)ptrs[2]; a.dirb = (const float*)ptrs[3];
  a.out = (float*)ptrs[4]; a.wout = (float*)ptrs[5];
  a.ws = ptrs[6]; a.bs = (const float*)ptrs[7];
  a.wf = ptrs[8]; a.bf = (const float*)ptrs[9];
  a.wdh = ptrs[10]; a.bd = (const float*)ptrs[11];
  a.wde = (const float*)ptrs[12];
  a.wc = ptrs[13]; a.bc = (const float*)ptrs[14];
  for (int i = 0; i < a.L; ++i) {
    a.wenc[i] = ptrs[15 + 3 * i];
    a.wh[i] = ptrs[16 + 3 * i];
    a.b[i] = (const float*)ptrs[17 + 3 * i];
    const bool with_enc = i == 0 || ((a.skip_mask >> i) & 1);
    if ((with_enc && !a.wenc[i]) || (i > 0 && !a.wh[i]) || !a.b[i])
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(a, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(render_fwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    render_fwd_kernel<true><<<a.N, NTHREADS, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(render_fwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    render_fwd_kernel<false><<<a.N, NTHREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}
