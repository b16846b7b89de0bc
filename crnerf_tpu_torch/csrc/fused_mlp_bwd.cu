// Backward of the per-point fused MLP: weight and bias gradients of the NeRF
// MLP from the forward's inputs (one coordinate per sample point, one
// direction per dir_rep points), the per-point cotangents of the features
// (M, C) and of sigma (M,), and the weights. No gradient for points or
// directions.
//
// Replaces crnerf_tpu/ops/fused_mlp.py:_make_bwd_kernel (the Pallas TPU
// kernel behind make_fused_mlp_train's VJP). That kernel recomputes one
// tile's forward in VMEM from the encode block it kept, backpropagates and
// adds into gradient blocks that stay resident across a sequential grid. On
// this card nothing carries between blocks and no block holds a tile's
// activations of every layer, so the recompute goes through device memory,
// through a scratch of a fixed size, as the fused render's recompute
// backward does; and nothing is kept from the forward but the points and
// directions (12 bytes a point instead of an encode block):
//
//   for each slab of P points, in point order
//     1. the forward's stash form fills the slab stash; features and sigma
//        are not written again;
//     2. the chain fills the slab dz buffer from the slab stash and the
//        slab's rows of the cotangents, and sums the bias and sigma-weight
//        gradients;
//     3. the split-K weight-gradient kernel (fused_render_bwd.cuh) writes
//        its partial tiles: dW = A^T dZ for every product, the dir-encode
//        rows included (their A is the stash's dir-encode columns);
//     4. the fixed-order sums of 2. and 3. add onto the slabs before.
//
// Two entries, one slab loop; the variant is chosen on the host by shape
// (mlp_bwd_variant in ops/fused_mlp.py), and route C's training forward
// takes the same variant, so that the slabs recompute the bits that
// forward computed (a ReLU mask open on one side and shut on the other
// would move a point's whole gradient term):
//   * crnerf_mlp_bwd_wgmma, at bf16 and the served widths with at most 8
//     trunk layers: 1. is the wgmma forward's STASH instance
//     (fused_mlp_fwd_wgmma.cuh), which adds stores to the inference
//     instance and nothing else, so its rows are the bits of the wgmma
//     forward route C runs; 2. is the wgmma chain (fused_mlp_bwd_wgmma.cuh).
//     A slab is a whole number of those kernels' waves of 128-point tiles.
//   * crnerf_mlp_bwd (fp32, other widths, deeper trunks): 1. is the
//     mma.sync forward's stash instantiation (fused_mlp_fwd.cuh), the
//     forward route C runs at those shapes; 2. is mlp_bwd_chain_kernel
//     (here).
// Step 3 is K2's weight gradient in both, the kernel the Python side names
// (wgrad_variant: wgmma at bf16 and the served widths, wgrad_wgmma.cuh).
//
// The mma.sync chain kernel, a persistent grid over tiles of CH = 64
// points: from the stash it recomputes z_sigma (fp32, as the forward) and
// the features, then
//   dz_feat = g_feat * f * (1 - f),  dz_sig = g_sigma * sigmoid(z_sigma)
// per point (where the fused render backward has the compositing backward),
// and walks feature head -> direction layer -> final layer + sigma head ->
// trunk with dz @ W^T products on transposed, packed weights. Each dz is
// written at the compute dtype to the dz buffer (the operands of step 3);
// the ReLU masks come from the stashed activations. Dtype policy as the TPU
// kernel's, in both chains: dz rounded to the compute dtype for both A^T dZ
// and dZ W^T, bias gradients from the unrounded fp32 dz, and the sigma
// branch wholly fp32: dz_sig and the sigma weights enter dh unrounded, and
// the sigma weight gradient h^T dz_sig is summed in the chain in fp32 (one
// thread per column, rows in order), not by the bf16 weight-gradient
// kernel. The dir-encode gradient is per point with ddd rounded per point,
// as the TPU kernel's mm_t(enc, ddd).
//
// Every sum has a fixed order (per CTA in shared memory with one owner per
// address, across CTAs, splits and slabs in index order): two runs on the
// same inputs on the same card give the same bits.
//
// What bounds it: the forward again (~1.2 MFLOP per point at 8x256) and the
// backward (~2.4 MFLOP per point) against 12 bytes of input and 4 (C + 1)
// bytes of cotangent per point: operations. What it costs as built: the
// stash and dz traffic through device memory (~15 KB per point).
// Left for later, in both variants: chaining from shared memory so that
// neither the stash nor dz reaches device memory.

#include <algorithm>

#include "fused_mlp_bwd_wgmma.cuh"
#include "fused_mlp_fwd_wgmma.cuh"

namespace {

struct CArgs {
  const float* gfeat;   // (M, C) cotangent of the features
  const float* gsig;    // (M) cotangent of sigma
  const void* stash;    // (M, SC)
  void* dzbuf;          // (M, DC)
  float* bpart;         // (grid, DC + WP) per-CTA bias / sigma-weight partials
  const float* wsrow;   // (WP) sigma weights, fp32, unrounded
  const float* bs;
  const void* wc; const float* bc;   // feature head as the forward takes it
  const void* wcT;      // (CP x HP) feature head transposed
  const void* wdhT;     // (HP x WP) dir layer, hidden rows, transposed
  const void* wfT;      // (WP x WP) final layer transposed
  const void* whT[MAXL];  // (WP x WP) trunk layer i, hidden rows, transposed
  int M, L, WP, HP, CP, C, SC, DC;
};

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, BF16 ? 2 : 1)
    mlp_bwd_chain_kernel(const CArgs a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int L = a.L, WP = a.WP, HP = a.HP, CP = a.CP;
  const int lda = WP + PAD, ldf = CP + 1, DC = a.DC;
  const int o_hf = L * WP, o_sig = (L + 1) * WP, o_ddd = o_sig + 32,
            o_feat = o_ddd + HP;

  T* P0 = reinterpret_cast<T*>(smem);
  T* P1 = P0 + CH * lda;
  float* feat = reinterpret_cast<float*>(P1 + CH * lda);   // CH * ldf
  float* bacc = feat + CH * ldf;        // 2 * DC: bias sums per row half
  float* swacc = bacc + 2 * DC;         // WP: sigma weight gradient
  float* zsig = swacc + WP;             // CH
  float* dzs = zsig + CH;               // CH

  for (int i = tid; i < 2 * DC + WP; i += NTHREADS) bacc[i] = 0.f;
  __syncthreads();

  const T* stash = static_cast<const T*>(a.stash);
  T* dzbuf = static_cast<T*>(a.dzbuf);
  const T* dd_mask = P1;
  const int n_tiles = (a.M + CH - 1) / CH;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * CH;
    const int nrows = min(CH, a.M - p0);
    const T* srow = stash + (size_t)p0 * a.SC;
    T* drow = dzbuf + (size_t)p0 * DC;
    // the mask rows read in the epilogues: rows past M repeat the last
    auto mask_row = [&](int r) {
      return srow + (size_t)min(r, nrows - 1) * a.SC;
    };
    load_rows<T>(P0, lda, srow + (L - 1) * WP, a.SC, WP, nrows);
    load_rows<T>(P1, lda, srow + (L + 1) * WP, a.SC, HP, nrows);
    __syncthreads();
    // the cheap heads again: z_sigma in fp32, the features
    rowdot_f32<T>(P0, lda, WP, a.wsrow, a.bs[0], zsig);
    {
      const float* bc = a.bc;
      auto epi_c = [&](int r, int c, float& v0, float& v1) {
        feat[r * ldf + c] = sigmoidf(v0 + bc[c]);
        feat[r * ldf + c + 1] = sigmoidf(v1 + bc[c + 1]);
      };
      gemm_cs<BF16, T>(P1, lda, HP, a.wc, CP, epi_c, nullptr, 0);
    }
    __syncthreads();
    if (tid < CH)
      dzs[tid] = tid < nrows ? a.gsig[p0 + tid] * sigmoidf(zsig[tid]) : 0.f;
    __syncthreads();
    // sigma head: bias and weight gradients in fp32, rows in order
    if (tid == 0) {
      float sb = 0.f;
      for (int r = 0; r < CH; ++r) sb += dzs[r];
      bacc[o_sig] += sb;
    }
    for (int k = tid; k < WP; k += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < CH; ++r) s += to_f<T>(P0[r * lda + k]) * dzs[r];
      swacc[k] += s;
    }
    __syncthreads();
    // dz_feat = g_feat * feat * (1 - feat), and its bias sum; the sigma
    // head's dz beside it (column 0 of a 32-wide block)
    for (int c = tid; c < CP; c += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < CH; ++r) {
        const float f = feat[r * ldf + c];
        const float g = (r < nrows && c < a.C)
                            ? a.gfeat[(size_t)(p0 + r) * a.C + c] : 0.f;
        const float v = g * f * (1.f - f);
        P0[r * lda + c] = to_t<T>(v);
        s += v;
      }
      bacc[o_feat + c] += s;
    }
    for (int i = tid; i < nrows * 32; i += NTHREADS) {
      const int r = i >> 5, c = i & 31;
      drow[(size_t)r * DC + o_sig + c] = to_t<T>(c == 0 ? dzs[r] : 0.f);
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
      gemm_cs<BF16, T>(P0, lda, CP, a.wcT, HP, epi, bacc + o_ddd, DC);
    }
    __syncthreads();
    if constexpr (!BF16) colsum_tile(P1, lda, HP, bacc + o_ddd);
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
    // dz_{L-1} = (h_{L-1} > 0) * (dhf @ Wf^T + dz_sig * w_sigma^T), the
    // sigma term in fp32; then down the trunk
    T* cur = P0;
    T* nxt = P1;
    for (int i = L - 1; i >= 0; --i) {
      const bool top = i == L - 1;
      const float* wsrow = a.wsrow;
      auto epi = [&](int r, int c, float& v0, float& v1) {
        if (top) {
          const float d = dzs[r];
          v0 += d * wsrow[c];
          v1 += d * wsrow[c + 1];
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

  float* bp = a.bpart + (size_t)blockIdx.x * (DC + WP);
  for (int c = tid; c < DC; c += NTHREADS) bp[c] = bacc[c] + bacc[DC + c];
  for (int k = tid; k < WP; k += NTHREADS) bp[DC + k] = swacc[k];
}

size_t mlp_chain_smem_bytes(const CArgs& a, bool bf16) {
  const size_t esz = bf16 ? 2 : 4;
  const size_t f_elems =
      (size_t)CH * (a.CP + 1) + 2 * a.DC + a.WP + 2 * CH;
  return 2 * (size_t)CH * (a.WP + PAD) * esz + f_elems * 4;
}

// One slab: the chain kernel on ``grid`` CTAs over M points, then the
// fixed-order sum of their partial rows into bout (DC + WP), onto what it
// holds with ``accumulate``.
int mlp_bwd_chain_launch(const CArgs& a, bool bf16, int grid, float* bout,
                         bool accumulate, cudaStream_t st) {
  const size_t smem = mlp_chain_smem_bytes(a, bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (bf16) {
    cudaFuncSetAttribute(mlp_bwd_chain_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    mlp_bwd_chain_kernel<true><<<grid, NTHREADS, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(mlp_bwd_chain_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    mlp_bwd_chain_kernel<false><<<grid, NTHREADS, smem, st>>>(a);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return reduce_partials(a.bpart, grid, a.DC + a.WP, accumulate, bout, st);
}

constexpr int MB_PTRS = 14;    // pointers before whT[1 .. L-1] (mma.sync)
constexpr int MBW_PTRS = 13;   // pointers before the forward's (wgmma)
constexpr int MB_DIMS = 23;
constexpr int MB_FWD_W = 9;    // wsrow, bs, wf, bf, wdh, bd, wde, wc, bc

// The slab loop of both entries (their pointers and dims below).
int mlp_bwd_slabs(const void* const* ptrs, int n_ptrs, const int* dims,
                  int n_dims, void* stream, bool wgmma) {
  if (n_dims != MB_DIMS) return (int)cudaErrorInvalidValue;
  const int M = dims[0], R = dims[1], L = dims[2];
  const int WP = dims[4], HP = dims[5], CP = dims[6], C = dims[7];
  const int bf16 = dims[13], SC = dims[14], DC = dims[15], grid = dims[16];
  const int P = dims[21];
  if (M < 1 || R < 1 || L < 1 || L > MAXL || P < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (WP % 32 || WP > 32 * MAX_NTW || HP % 32 || HP > WP || CP % 32 ||
      CP > WP || C > CP || C < 1 || SC % 16 ||
      DC != (L + 1) * WP + 32 + HP + CP)
    return (int)cudaErrorInvalidValue;
  const int n_bwd = wgmma ? MBW_PTRS : MB_PTRS + (L - 1);
  if (n_ptrs != n_bwd + MB_FWD_W + 3 * L) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_bwd; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const void* const* fw = ptrs + n_bwd;   // wsrow, bs, ..., bc, layer triples
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // the forward's pointers: no features, no sigma, the slab stash
  const void* fp[MLP_FWD_PTRS + 3 * MAXL + 1];
  fp[1] = ptrs[1];
  fp[2] = nullptr; fp[3] = nullptr;
  fp[4] = ptrs[4];
  for (int i = 0; i < MB_FWD_W + 3 * L; ++i) fp[5 + i] = fw[i];
  int n_fp = MLP_FWD_PTRS + 3 * L;
  if (wgmma) fp[n_fp++] = ptrs[12];       // the forward's weight stream

  CArgs c = {};
  MWArgs w = {};
  c.stash = ptrs[4]; c.dzbuf = const_cast<void*>(ptrs[5]);
  c.bpart = (float*)ptrs[6];
  float* bout = (float*)ptrs[7];
  c.wsrow = (const float*)fw[0]; c.bs = (const float*)fw[1];
  c.wc = fw[7]; c.bc = (const float*)fw[8];
  if (!wgmma) {
    c.wcT = ptrs[11]; c.wdhT = ptrs[12]; c.wfT = ptrs[13];
    for (int i = 1; i < L; ++i) c.whT[i] = ptrs[13 + i];
  }
  c.L = L; c.WP = WP; c.HP = HP; c.CP = CP; c.C = C; c.SC = SC; c.DC = DC;
  w.dzbuf = (__nv_bfloat16*)c.dzbuf; w.bpart = c.bpart;
  w.wsrow = c.wsrow; w.bs = c.bs; w.bc = c.bc;
  w.L = L; w.C = C; w.DC = DC;
  const void* wp[WGRAD_PTRS] = {ptrs[4], ptrs[5], ptrs[8], ptrs[9], ptrs[10]};

  for (int r0 = 0; r0 < M; r0 += P) {
    const int n = std::min(P, M - r0);
    const bool accumulate = r0 > 0;
    fp[0] = static_cast<const float*>(ptrs[0]) + (size_t)r0 * 3;
    // M, R, p_base, L, skip_mask, WP, HP, CP, C, KE, F, DK, DKP, exact,
    // BF16, SC
    const int fd[MLP_FWD_DIMS] = {n, R, r0, L, dims[3], WP, HP, CP, C,
                                  dims[8], dims[9], dims[10], dims[11],
                                  dims[12], bf16, SC};
    int rc = wgmma ? mlp_fwd_wgmma_entry(fp, n_fp, fd, MLP_FWD_DIMS, stream)
                   : mlp_fwd_entry(fp, n_fp, fd, MLP_FWD_DIMS, stream);
    if (rc != 0) return rc;
    const float* gfeat = static_cast<const float*>(ptrs[2]) + (size_t)r0 * C;
    const float* gsig = static_cast<const float*>(ptrs[3]) + r0;
    if (wgmma) {   // the chain's grid: at most its 128-point tiles
      w.M = n; w.gfeat = gfeat; w.gsig = gsig;
      rc = mlp_bwd_chain_wgmma_launch(w, c.stash, SC, ptrs[11],
                                      std::min(grid, (n + 127) / 128), bout,
                                      accumulate, st);
    } else {
      c.M = n; c.gfeat = gfeat; c.gsig = gsig;
      rc = mlp_bwd_chain_launch(c, bf16 != 0,
                                std::min(grid, (n + CH - 1) / CH), bout,
                                accumulate, st);
    }
    if (rc != 0) return rc;
    // M, SC, DC, WT, n_tiles, splits, m_per, kernel
    const int wd[WGRAD_DIMS] = {n, SC, DC, dims[17], dims[18], dims[19],
                                dims[20], dims[22]};
    rc = render_bwd_wgrad_entry(wp, WGRAD_PTRS, wd, WGRAD_DIMS, stream,
                                accumulate);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// ptrs (host array): xyz, dirb, gfeat, gsig, stash (P x SC scratch), dzbuf
// (P x DC scratch), bpart (grid x (DC + WP)), bout (DC + WP), tiles, part
// (splits x WT), wout (WT), wcT, wdhT, wfT, whT[1 .. L-1], then the
// forward's weights as crnerf_mlp_fwd takes them (wsrow .. bc, then per
// trunk layer wenc, wh, b).
// dims: M, R, L, skip_mask, WP, HP, CP, C, KE, F, DK, DKP, exact, BF16, SC,
// DC, grid, WT, n_tiles, splits, m_per, P (points per slab), WK (the
// weight gradient's kernel, as render_bwd_wgrad_entry takes it; the tile
// table is that kernel's). ``splits`` and ``m_per`` cut P points; ``grid``
// is at most the tiles of P points.
// Writes bout and wout; returns the first error of any launch.
extern "C" int crnerf_mlp_bwd(const void* const* ptrs, int n_ptrs,
                              const int* dims, int n_dims, void* stream) {
  return mlp_bwd_slabs(ptrs, n_ptrs, dims, n_dims, stream, false);
}

// ptrs: as crnerf_mlp_bwd's up to wout, then the wgmma chain's weight
// stream (wgmma_chain_weights), the wgmma forward's (wgmma_mlp_weights),
// then the forward's weights. dims as there, ``grid`` at most the wgmma
// chain's 128-point tiles of P points and the SMs. Only the shapes both
// wgmma kernels take (each refuses others).
extern "C" int crnerf_mlp_bwd_wgmma(const void* const* ptrs, int n_ptrs,
                                    const int* dims, int n_dims,
                                    void* stream) {
  return mlp_bwd_slabs(ptrs, n_ptrs, dims, n_dims, stream, true);
}
