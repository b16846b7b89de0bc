// Backward of the fused render pass from the forward's activation stash:
// weight and bias gradients of the NeRF MLP, summed over all sample points.
// No gradient for rays, z or noise.
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_bwd_stash_kernel (the
// Pallas TPU kernel). That kernel sums the weight gradients in VMEM across
// a sequential grid; on this card nothing carries between blocks and no
// block can hold 0.6 M gradient values while it walks the points, so the
// work is two kernels with a buffer of dz between them:
//
//   1. crnerf_render_bwd_chain, one CTA (8 warps) per ray at a time, a
//      persistent grid. It recomputes the cheap heads from the stash (z_sig
//      and feat), the compositing forward and its backward per ray (the two
//      scans run in one thread: 2 S steps against ~160 MFLOP of products
//      per ray), then walks the dh chain per 64-sample chunk: feature head,
//      direction layer, final layer + sigma head, trunk. Each product is
//      dz @ W^T with the transposed weights packed by the wrapper; each dz
//      is written at the compute dtype into the dz buffer, one row per
//      point, [dz_0 .. dz_{L-1} | dhf | dz_sig (32) | ddd | dz_feat]. The
//      ReLU masks come from the stashed activations. Bias gradients are
//      column sums of the unrounded fp32 dz, kept per CTA in shared memory
//      (every column of every product has exactly one owner thread per
//      row half, so there are no atomics) and written as one partial row
//      per CTA. Each ray's summed ddd is written out, and a small kernel
//      (dir_wgrad_kernel) sums the per-ray outer products with the
//      direction encode: the direction-encode weight gradient. Keeping
//      that accumulator out of shared memory lets two CTAs share an SM.
//   2. crnerf_render_bwd_wgrad, split-K: dW = A^T dZ over the points, A a
//      column block of the stash, dZ a column block of the dz buffer. Each
//      CTA owns one 128x128 output tile (64x64 at fp32) and one slice of
//      the points, streams both operands through shared memory with
//      cp.async double buffering, reads them transposed with
//      ldmatrix.trans into mma.sync m16n8k16 (bf16 in, fp32 accumulate)
//      and writes one partial tile. At bf16 and the served widths its
//      wgmma / TMA counterpart runs instead (wgrad_wgmma.cuh, which holds
//      the entry that picks the kernel).
//   Both end in reduce_partials: out[i] = sum over partials in index
//   order. Every sum has a fixed order, so two runs on the same inputs on
//   the same card give the same bits.
//
// What bounds it: ~2.4 MFLOP of products per point at 8x256 against ~10 KB
// per point read (stash, then dz) and ~5 KB written (dz): about 160
// operations per byte, under the card's ~295, so device memory bounds it
// by a small margin once the products run near the tensor cores' rate.
// Dtype policy as the TPU kernel's: every product operand (activations and
// dz) rounded to the compute dtype, fp32 accumulation; compositing, the
// g_fmap . feat products and the bias sums fp32.
// The chain kernel here is the mma.sync one: fp32, widths other than the
// served MLPs' and the recompute backward's slabs. The stash route's bf16
// chain at the served widths runs its wgmma / TMA counterpart
// (fused_render_bwd_wgmma.cuh), chosen by shape in ops/fused_render.py
// chain_variant. Left for later: fusing the weight gradient into the
// chain so dz never reaches device memory.
//
// Included by fused_render_bwd.cu (the stash backward's library) and by
// fused_render_bwd_recompute.cu, which runs both kernels slab by slab on a
// stash it recomputes; there every final sum adds onto the slabs before
// (``accumulate``), still in a fixed order.

#pragma once

#include "fused_render_common.cuh"

namespace {

struct BArgs {
  const float* z;       // (N, S)
  const float* noise;   // (N, S)
  const float* dirb;    // (N, DK) dir encode at the compute dtype
  const float* gray;    // (N, ldo) cotangent of [fmap | depth | 0]
  const float* gw;      // (N, S) cotangent of the weights
  const void* stash;    // (N*S, SC)
  void* dzbuf;          // (N*S, DC)
  float* bpart;         // (grid, DC) per-CTA bias partials
  float* ddray;         // (N, HP) each ray's summed ddd, as a product operand
  const void* ws; const float* bs;   // sigma head as the forward takes it
  const void* wc; const float* bc;   // feature head as the forward takes it
  const float* wsv;     // (WP) sigma weights at the compute dtype
  const void* wcT;      // (CP x HP) feature head transposed
  const void* wdhT;     // (HP x WP) dir layer, hidden rows, transposed
  const void* wfT;      // (WP x WP) final layer transposed
  const void* whT[MAXL];  // (WP x WP) trunk layer i, hidden rows, transposed
  int N, S, L, WP, HP, CP, C, DK, ldo, SC, DC;
};

// out = epi(A @ W) over the CH-row tile; epi(row, col, v0&, v1&) transforms
// two adjacent columns and stores them. bf16: the column sums of the
// transformed values are added to cs[half * cs_ld + col], half = the
// warp's row half (one owner per address). fp32: the caller sums columns
// from the stored tile (colsum_tile), where the stored value is the value.
template <bool BF16, typename T, class Epi>
__device__ __forceinline__ void gemm_cs(const T* A, int lda, int K,
                                        const void* W, int n_pad, Epi epi,
                                        float* cs, int cs_ld) {
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
    mma_accumulate(acc, A, lda, K >> 4, static_cast<const uint2*>(W),
                   nt_total, nt0, ntw, m0, lane);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < MAX_NTW; ++j)
      if (j < ntw) {
        const int col = (nt0 + j) * 8 + 2 * t;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = m0 + mi * 16 + g;
          epi(row, col, acc[mi][j][0], acc[mi][j][1]);
          epi(row + 8, col, acc[mi][j][2], acc[mi][j][3]);
          s0 += acc[mi][j][0] + acc[mi][j][2];
          s1 += acc[mi][j][1] + acc[mi][j][3];
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (cs != nullptr && g == 0) {
          float* dst = cs + (warp & 1) * cs_ld + col;
          dst[0] += s0;
          dst[1] += s1;
        }
      }
  } else {
    float acc[4][MAX_NTW][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
    const int nj = n_pad >> 5;
    simt_accumulate(acc, A, lda, K, static_cast<const float*>(W), n_pad, nj,
                    tid);
    const int rg = tid >> 4, cg = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NTW; ++j)
        if (j < nj)
          epi(rg * 4 + i, 32 * j + 2 * cg, acc[i][j][0], acc[i][j][1]);
  }
}

// fp32 tiles: cs[col] += sum over the tile's rows, in row order.
__device__ __forceinline__ void colsum_tile(const float* tile, int ld,
                                            int ncols, float* cs) {
  for (int c = threadIdx.x; c < ncols; c += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < CH; ++r) s += tile[r * ld + c];
    cs[c] += s;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, BF16 ? 2 : 1)
    render_bwd_chain_kernel(const BArgs a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int S = a.S, L = a.L, WP = a.WP, HP = a.HP, CP = a.CP;
  const int lda = WP + PAD, ldf = CP + 1, DC = a.DC;
  const int o_hf = L * WP, o_sig = (L + 1) * WP, o_ddd = o_sig + 32,
            o_feat = o_ddd + HP;

  T* P0 = reinterpret_cast<T*>(smem);
  T* P1 = P0 + CH * lda;
  float* feat = reinterpret_cast<float*>(P1 + CH * lda);   // CH * ldf
  float* bacc = feat + CH * ldf;        // 2 * DC: bias sums per row half
  float* ddacc = bacc + 2 * DC;         // 2 * HP: this ray's ddd sums
  float* gfm = ddacc + 2 * HP;          // CP
  float* zsig = gfm + CP;               // per-ray arrays, S each
  float* gft = zsig + S;
  float* al = gft + S;
  float* tr = al + S;
  float* wt = tr + S;
  float* dw = wt + S;
  float* dl = dw + S;
  float* ex = dl + S;
  float* pre = ex + S;
  float* dzs = pre + S;

  for (int i = tid; i < 2 * DC; i += NTHREADS) bacc[i] = 0.f;
  __syncthreads();

  const T* stash = static_cast<const T*>(a.stash);
  T* dzbuf = static_cast<T*>(a.dzbuf);
  const T* dd_mask = P1;

  for (int ray = blockIdx.x; ray < a.N; ray += gridDim.x) {
    const float* gr = a.gray + (size_t)ray * a.ldo;
    const float* zr = a.z + (size_t)ray * S;
    const float* nr = a.noise + (size_t)ray * S;
    const float* gwr = a.gw + (size_t)ray * S;
    const T* srow0 = stash + (size_t)ray * S * a.SC;
    T* drow0 = dzbuf + (size_t)ray * S * DC;
    for (int c = tid; c < CP; c += NTHREADS) gfm[c] = c < a.C ? gr[c] : 0.f;
    for (int c = tid; c < 2 * HP; c += NTHREADS) ddacc[c] = 0.f;
    const float ddepth = gr[a.C];

    // ---- phase 1: z_sig and g_fmap . feat of every sample of the ray
    for (int c0 = 0; c0 < S; c0 += CH) {
      const int nrows = min(CH, S - c0);
      const T* srow = srow0 + (size_t)c0 * a.SC;
      load_rows<T>(P0, lda, srow + (L - 1) * WP, a.SC, WP, nrows);
      load_rows<T>(P1, lda, srow + (L + 1) * WP, a.SC, HP, nrows);
      __syncthreads();
      {
        const float* bs = a.bs;
        auto epi_s = [&](int r, int c, float& v0, float&) {
          if (c == 0 && c0 + r < S) zsig[c0 + r] = v0 + bs[0];
        };
        gemm_cs<BF16, T>(P0, lda, WP, a.ws, 32, epi_s, nullptr, 0);
        const float* bc = a.bc;
        auto epi_c = [&](int r, int c, float& v0, float& v1) {
          feat[r * ldf + c] = sigmoidf(v0 + bc[c]);
          feat[r * ldf + c + 1] = sigmoidf(v1 + bc[c + 1]);
        };
        gemm_cs<BF16, T>(P1, lda, HP, a.wc, CP, epi_c, nullptr, 0);
      }
      __syncthreads();
      if (tid < nrows) {
        float s = 0.f;
        for (int c = 0; c < CP; ++c) s += gfm[c] * feat[tid * ldf + c];
        gft[c0 + tid] = s;
      }
      __syncthreads();
    }

    // ---- compositing forward and backward of the ray
    for (int j = tid; j < S; j += NTHREADS) {
      const float zj = zr[j];
      const float delta = j < S - 1 ? zr[j + 1] - zj : DELTA_INF;
      const float p = softplusf(zsig[j]) + nr[j];
      const float e = expf(-delta * fmaxf(p, 0.f));
      dl[j] = delta;
      pre[j] = p;
      ex[j] = e;
      al[j] = 1.f - e;
      dw[j] = gwr[j] + ddepth * zj + gft[j];
    }
    __syncthreads();
    if (tid == 0) {
      float t = 1.f;
      for (int j = 0; j < S; ++j) {
        tr[j] = t;
        wt[j] = al[j] * t;
        t *= 1.f - al[j];
      }
      float suf = 0.f;   // sum over k > j of weights * dw
      for (int j = S - 1; j >= 0; --j) {
        const float one_m = fmaxf(1.f - al[j], 1e-30f);
        const float dalpha = tr[j] * dw[j] - suf / one_m;
        suf += wt[j] * dw[j];
        const float dact = dalpha * dl[j] * ex[j];
        dzs[j] = pre[j] > 0.f ? dact * sigmoidf(zsig[j]) : 0.f;
      }
      float sb = 0.f;
      for (int j = 0; j < S; ++j) sb += dzs[j];
      bacc[o_sig] += sb;
    }
    __syncthreads();

    // ---- phase 2: the dh chain, chunk by chunk
    for (int c0 = 0; c0 < S; c0 += CH) {
      const int nrows = min(CH, S - c0);
      const T* srow = srow0 + (size_t)c0 * a.SC;
      T* drow = drow0 + (size_t)c0 * DC;
      // the mask rows read in the epilogues: rows past S repeat the last
      auto mask_row = [&](int r) {
        return srow + (size_t)min(r, nrows - 1) * a.SC;
      };
      load_rows<T>(P1, lda, srow + (L + 1) * WP, a.SC, HP, nrows);
      __syncthreads();
      {
        const float* bc = a.bc;
        auto epi_c = [&](int r, int c, float& v0, float& v1) {
          feat[r * ldf + c] = sigmoidf(v0 + bc[c]);
          feat[r * ldf + c + 1] = sigmoidf(v1 + bc[c + 1]);
        };
        gemm_cs<BF16, T>(P1, lda, HP, a.wc, CP, epi_c, nullptr, 0);
      }
      __syncthreads();
      // dz_feat = weights * g_fmap * feat * (1 - feat), and its bias sum;
      // the sigma head's dz beside it (column 0 of a 32-wide block)
      for (int c = tid; c < CP; c += NTHREADS) {
        float s = 0.f;
        const float g = gfm[c];
        for (int r = 0; r < CH; ++r) {
          const float f = feat[r * ldf + c];
          const float v = r < nrows ? wt[c0 + r] * g * f * (1.f - f) : 0.f;
          P0[r * lda + c] = to_t<T>(v);
          s += v;
        }
        bacc[o_feat + c] += s;
      }
      for (int i = tid; i < nrows * 32; i += NTHREADS) {
        const int r = i >> 5, c = i & 31;
        drow[(size_t)r * DC + o_sig + c] =
            to_t<T>(c == 0 ? dzs[c0 + r] : 0.f);
      }
      __syncthreads();
      store_rows<T>(drow + o_feat, DC, P0, lda, CP, nrows);
      // ddd = (dd > 0) * dz_feat @ Wc^T, in place over dd
      {
        auto epi = [&](int r, int c, float& v0, float& v1) {
          T* p = P1 + r * lda + c;
          v0 = to_f<T>(dd_mask[r * lda + c]) > 0.f ? v0 : 0.f;
          v1 = to_f<T>(dd_mask[r * lda + c + 1]) > 0.f ? v1 : 0.f;
          store2<T>(p, v0, v1);
        };
        gemm_cs<BF16, T>(P0, lda, CP, a.wcT, HP, epi, ddacc, HP);
      }
      __syncthreads();
      if constexpr (!BF16) colsum_tile(P1, lda, HP, ddacc);
      store_rows<T>(drow + o_ddd, DC, P1, lda, HP, nrows);
      // dhf = ddd @ Wdh^T
      {
        auto epi = [&](int r, int c, float& v0, float& v1) {
          store2<T>(P0 + r * lda + c, v0, v1);
        };
        gemm_cs<BF16, T>(P1, lda, HP, a.wdhT, WP, epi, bacc + o_hf, DC);
      }
      __syncthreads();
      if constexpr (!BF16) colsum_tile(P0, lda, WP, bacc + o_hf);
      store_rows<T>(drow + o_hf, DC, P0, lda, WP, nrows);
      // dz_{L-1} = (h_{L-1} > 0) * (dhf @ Wf^T + dz_sig * w_sigma^T)
      T* cur = P0;
      T* nxt = P1;
      for (int i = L - 1; i >= 0; --i) {
        const bool top = i == L - 1;
        const float* wsv = a.wsv;
        auto epi = [&](int r, int c, float& v0, float& v1) {
          if (top) {
            const float d =
                r < nrows ? to_f<T>(to_t<T>(dzs[c0 + r])) : 0.f;
            v0 += d * wsv[c];
            v1 += d * wsv[c + 1];
          }
          const T* m = mask_row(r) + i * WP + c;
          v0 = to_f<T>(m[0]) > 0.f ? v0 : 0.f;
          v1 = to_f<T>(m[1]) > 0.f ? v1 : 0.f;
          store2<T>(nxt + r * lda + c, v0, v1);
        };
        gemm_cs<BF16, T>(cur, lda, WP, top ? a.wfT : a.whT[i + 1], WP, epi,
                         bacc + i * WP, DC);
        __syncthreads();
        if constexpr (!BF16) colsum_tile(nxt, lda, WP, bacc + i * WP);
        store_rows<T>(drow + i * WP, DC, nxt, lda, WP, nrows);
        T* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      __syncthreads();
    }

    // ---- the ray's direction-layer sums: the bias, and the ray's summed
    // ddd rounded as the product operand it is in the dir-encode gradient
    for (int n = tid; n < HP; n += NTHREADS) {
      const float tot = ddacc[n] + ddacc[HP + n];
      bacc[o_ddd + n] += tot;
      a.ddray[(size_t)ray * HP + n] = to_f<T>(to_t<T>(tot));
    }
    __syncthreads();
  }

  float* bp = a.bpart + (size_t)blockIdx.x * DC;
  for (int c = tid; c < DC; c += NTHREADS) bp[c] = bacc[c] + bacc[DC + c];
}

// Direction-encode weight gradient: out[slice][e][n] = sum over the
// slice's rays, in ray order, of dirb[ray][e] * ddray[ray][n].
__global__ void dir_wgrad_kernel(const float* __restrict__ dirb,
                                 const float* __restrict__ ddray, int n_rays,
                                 int dk, int hp, int rays_per_slice,
                                 float* __restrict__ part) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dk * hp) return;
  const int e = i / hp, n = i % hp;
  const int r0 = blockIdx.y * rays_per_slice;
  const int r1 = min(n_rays, r0 + rays_per_slice);
  float s = 0.f;
  for (int r = r0; r < r1; ++r)
    s += dirb[(size_t)r * dk + e] * ddray[(size_t)r * hp + n];
  part[(size_t)blockIdx.y * dk * hp + i] = s;
}

size_t chain_smem_bytes(const BArgs& a, bool bf16) {
  const size_t esz = bf16 ? 2 : 4;
  const size_t f_elems = (size_t)CH * (a.CP + 1) + 2 * a.DC + 2 * a.HP +
                         a.CP + 10 * (size_t)a.S;
  return 2 * (size_t)CH * (a.WP + PAD) * esz + f_elems * 4;
}

// out[i] = (accumulate ? out[i] : 0) + part[0][i] + part[1][i] + ... in
// index order
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       int n_parts, int total,
                                       bool accumulate, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = accumulate ? out[i] : 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * total + i];
  out[i] = s;
}

// ------------------------------------------------------- weight gradient
// One row of the tile table: the output tile out[out_off + r * ld_out + c],
// r < k_valid, c < n_valid, = sum over points of stash[p][a_col + r] *
// dzbuf[p][b_col + c].
struct Tile { int a_col, k_valid, b_col, n_valid, out_off, ld_out; };

struct WArgs {
  const void* stash; const void* dzbuf;
  const Tile* tiles;
  float* part;          // (splits, WT)
  int M, SC, DC, WT, m_per;
};

constexpr int WG_T = 128;    // bf16 output tile
constexpr int WG_PT = 64;    // points per stage
constexpr int WG_LD = WG_T + 8;

__global__ void __launch_bounds__(NTHREADS, 2)
    wgrad_bf16_kernel(const WArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = As + 2 * WG_PT * WG_LD;
  const Tile tl = a.tiles[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m_begin = blockIdx.y * a.m_per;
  const int m_end = min(a.M, m_begin + a.m_per);
  const int nsteps = (m_end - m_begin + WG_PT - 1) / WG_PT;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a.stash);
  const __nv_bfloat16* D = static_cast<const __nv_bfloat16*>(a.dzbuf);

  auto load = [&](int step, int stage) {
    const int p0 = m_begin + step * WG_PT;
    __nv_bfloat16* as = As + stage * WG_PT * WG_LD;
    __nv_bfloat16* ds = Ds + stage * WG_PT * WG_LD;
    for (int v = tid; v < WG_PT * (WG_T / 8); v += NTHREADS) {
      const int p = v / (WG_T / 8), c = (v % (WG_T / 8)) * 8;
      const bool row_ok = p0 + p < m_end;
      const bool a_ok = row_ok && c < tl.k_valid;
      const bool d_ok = row_ok && c < tl.n_valid;
      cp_async16(as + p * WG_LD + c,
                 a_ok ? A + (size_t)(p0 + p) * a.SC + tl.a_col + c : A,
                 a_ok ? 16 : 0);
      cp_async16(ds + p * WG_LD + c,
                 d_ok ? D + (size_t)(p0 + p) * a.DC + tl.b_col + c : D,
                 d_ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (nsteps > 0) load(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      load(s + 1, (s + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* as = As + (s & 1) * WG_PT * WG_LD;
    const __nv_bfloat16* ds = Ds + (s & 1) * WG_PT * WG_LD;
    const int mj = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < WG_PT / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi],
                          as + (kk * 16 + (mj >> 1) * 8 + r) * WG_LD +
                              wm * 64 + mi * 16 + (mj & 1) * 8);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldmatrix_x4_trans(bf[pr],
                          ds + (kk * 16 + (mj & 1) * 8 + r) * WG_LD +
                              wn * 32 + pr * 16 + (mj >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma16816(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  float* out = a.part + (size_t)blockIdx.y * a.WT + tl.out_off;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + 2 * t;
      if (col >= tl.n_valid) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wm * 64 + mi * 16 + g + hf * 8;
        if (row < tl.k_valid)
          *reinterpret_cast<float2*>(out + (size_t)row * tl.ld_out + col) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    }
}

constexpr int WF_T = 64;     // fp32 output tile
constexpr int WF_PT = 32;

__global__ void __launch_bounds__(NTHREADS)
    wgrad_f32_kernel(const WArgs a) {
  __shared__ __align__(16) float As[WF_PT][WF_T];
  __shared__ __align__(16) float Ds[WF_PT][WF_T];
  const Tile tl = a.tiles[blockIdx.x];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m_begin = blockIdx.y * a.m_per;
  const int m_end = min(a.M, m_begin + a.m_per);
  const float* A = static_cast<const float*>(a.stash);
  const float* D = static_cast<const float*>(a.dzbuf);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p0 = m_begin; p0 < m_end; p0 += WF_PT) {
    for (int v = tid; v < WF_PT * (WF_T / 4); v += NTHREADS) {
      const int p = v / (WF_T / 4), c = (v % (WF_T / 4)) * 4;
      const bool row_ok = p0 + p < m_end;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), dv = av;
      if (row_ok && c < tl.k_valid)
        av = __ldg(reinterpret_cast<const float4*>(
            A + (size_t)(p0 + p) * a.SC + tl.a_col + c));
      if (row_ok && c < tl.n_valid)
        dv = __ldg(reinterpret_cast<const float4*>(
            D + (size_t)(p0 + p) * a.DC + tl.b_col + c));
      *reinterpret_cast<float4*>(&As[p][c]) = av;
      *reinterpret_cast<float4*>(&Ds[p][c]) = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < WF_PT; ++p) {
      const float4 av = *reinterpret_cast<const float4*>(&As[p][ty * 4]);
      const float4 dv = *reinterpret_cast<const float4*>(&Ds[p][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * dr[j];
    }
    __syncthreads();
  }
  float* out = a.part + (size_t)blockIdx.y * a.WT + tl.out_off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ty * 4 + i, col = tx * 4 + j;
      if (row < tl.k_valid && col < tl.n_valid)
        out[(size_t)row * tl.ld_out + col] = acc[i][j];
    }
}

int reduce_partials(const float* part, int n_parts, int total,
                    bool accumulate, float* out, cudaStream_t st) {
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, n_parts, total, accumulate, out);
  return (int)cudaGetLastError();
}

// After a chain kernel: the fixed-order sum of its grid partial rows of
// bias sums into bout[:DC], then the direction-encode weight gradient over
// ``slices`` slices of the rays and its fixed-order sum into bout[DC:];
// with ``accumulate`` both sums start from what bout holds.
int chain_sums(const float* bpart, int grid, int DC, const float* dirb,
               const float* ddray, int N, int DK, int HP, int slices,
               float* dpart, float* bout, bool accumulate, cudaStream_t st) {
  int rc = reduce_partials(bpart, grid, DC, accumulate, bout, st);
  if (rc != 0) return rc;
  const int n_dir = DK * HP;
  const int per_slice = (N + slices - 1) / slices;
  dir_wgrad_kernel<<<dim3((n_dir + 255) / 256, slices), 256, 0, st>>>(
      dirb, ddray, N, DK, HP, per_slice, dpart);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return reduce_partials(dpart, slices, n_dir, accumulate, bout + DC, st);
}

constexpr int CHAIN_PTRS = 19;   // pointers before whT[1 .. L-1]
constexpr int CHAIN_DIMS = 14;
constexpr int WGRAD_PTRS = 5;
constexpr int WGRAD_DIMS = 8;

// ptrs (host array): z, noise, dirb, gray, gw, stash, dzbuf, bpart (grid x
// DC), ddray (N x HP), dpart (slices x DK*HP), bout (DC + DK*HP), ws, bs,
// wc, bc, wsv, wcT, wdhT, wfT, then whT[1 .. L-1].
// dims: N, S, L, WP, HP, CP, C, DK, ldo, SC, DC, slices, BF16, grid.
// Launches the chain kernel on ``grid`` CTAs, then chain_sums.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernels do not take).
int render_bwd_chain_entry(const void* const* ptrs, int n_ptrs,
                           const int* dims, int n_dims, void* stream,
                           bool accumulate) {
  if (n_dims != CHAIN_DIMS) return (int)cudaErrorInvalidValue;
  BArgs a = {};
  a.N = dims[0]; a.S = dims[1]; a.L = dims[2]; a.WP = dims[3];
  a.HP = dims[4]; a.CP = dims[5]; a.C = dims[6]; a.DK = dims[7];
  a.ldo = dims[8]; a.SC = dims[9]; a.DC = dims[10];
  const int slices = dims[11];
  const bool bf16 = dims[12] != 0;
  const int grid = dims[13];
  if (a.N < 1 || a.S < 1 || a.L < 1 || a.L > MAXL || grid < 1 ||
      slices < 1 || slices > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_ptrs != CHAIN_PTRS + (a.L - 1)) return (int)cudaErrorInvalidValue;
  if (a.WP % 32 || a.WP > 32 * MAX_NTW || a.HP % 32 || a.HP > a.WP ||
      a.CP % 32 || a.CP > 32 * MAX_NTW || a.C > a.CP || a.C >= a.ldo ||
      a.SC < (a.L + 1) * a.WP + a.HP || a.SC % 16 ||
      a.DC != (a.L + 1) * a.WP + 32 + a.HP + a.CP)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  a.z = (const float*)ptrs[0]; a.noise = (const float*)ptrs[1];
  a.dirb = (const float*)ptrs[2]; a.gray = (const float*)ptrs[3];
  a.gw = (const float*)ptrs[4]; a.stash = ptrs[5];
  a.dzbuf = const_cast<void*>(ptrs[6]);
  a.bpart = (float*)ptrs[7];
  a.ddray = (float*)ptrs[8];
  float* dpart = (float*)ptrs[9];
  float* bout = (float*)ptrs[10];
  a.ws = ptrs[11]; a.bs = (const float*)ptrs[12];
  a.wc = ptrs[13]; a.bc = (const float*)ptrs[14];
  a.wsv = (const float*)ptrs[15];
  a.wcT = ptrs[16]; a.wdhT = ptrs[17]; a.wfT = ptrs[18];
  for (int i = 1; i < a.L; ++i) a.whT[i] = ptrs[18 + i];
  const size_t smem = chain_smem_bytes(a, bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    cudaFuncSetAttribute(render_bwd_chain_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    render_bwd_chain_kernel<true><<<grid, NTHREADS, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(render_bwd_chain_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    render_bwd_chain_kernel<false><<<grid, NTHREADS, smem, st>>>(a);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return chain_sums(a.bpart, grid, a.DC, a.dirb, a.ddray, a.N, a.DK, a.HP,
                    slices, dpart, bout, accumulate, st);
}

}  // namespace
