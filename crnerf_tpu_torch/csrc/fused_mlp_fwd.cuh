// Fused NeRF-MLP forward per sample point: positional encode, the trunk with
// its skip, the sigma / final / direction / feature heads in ONE kernel. Per
// point it writes the features (M, C) f32 in [0, 1] and softplus sigma (M,)
// f32; compositing is the caller's (plain, differentiable PyTorch).
//
// Replaces crnerf_tpu/ops/fused_mlp.py:_make_fwd_kernel (the Pallas TPU
// kernel behind fused_mlp_apply and the forward of make_fused_mlp_train).
// That kernel streams a 128-lane grouped encode block per point, built
// outside at the compute dtype, through row-permuted weights with zero rows,
// and writes one lane-packed (N, 128) block [features | sigma | 0]. None of
// that layout comes along: this kernel reads 12 bytes a point, encodes in
// shared memory (as the fused render kernel's xyz-in form does) and writes
// two dense outputs.
//
// What bounds it: ~1.2 MFLOP of products per point at 8x256 against 12 bytes
// read and 4 (C + 1) bytes written per point (260 at C = 64): operations, by
// a wide margin even with the per-point stores.
// Design:
//   * One CTA (8 warps) per tile of CH = 64 consecutive POINTS, whatever ray
//     they belong to: N, S and dir_rep need be multiples of nothing. Rows
//     past the last point repeat it and are not stored.
//   * The direction of point p is dirs[(p_base + p) / dir_rep]. Its encode
//     (made per direction by the wrapper, at the compute dtype) is gathered
//     into a 64 x DKP tile, and the direction layer is one product over
//     [hf | dir encode] @ [W_dh ; W_de]: two operand tiles into one
//     accumulator, as the skip layer takes [encode | h]. This is the TPU
//     kernel's mm(hf, wd_h) + mm(enc, wd_e), per point, and it makes
//     dir_rep = 1 (a direction per point) no special case; the two extra
//     k-steps are 1% of the products.
//   * Trunk, final, direction and feature layers as the fused render
//     forward: mma.sync m16n8k16 at bf16 (fp32 accumulate), SIMT FMA at
//     fp32, activations ping-pong in shared memory, weights pre-packed in
//     fragment order and read through L2.
//   * Dtype policy as the TPU kernel's: ReLU outputs, hf and dd cast to the
//     compute dtype; the SIGMA HEAD IN FP32 on the unrounded fp32 sigma
//     weights (a 64 x WP dot product on the CUDA cores: each warp takes 8
//     rows, lanes stride the columns, a shuffle tree sums; fixed order);
//     biases, softplus, sigmoid fp32. This differs from the fused render
//     kernels, whose sigma head runs at the compute dtype.
//   * Stores: the tile's features are nrows * C consecutive floats of the
//     (M, C) output, written 4 bytes a thread, neighbouring threads on
//     neighbouring addresses, from the shared-memory tile; sigma likewise.
//     A 65-column [features | sigma] row would start on no 16-byte boundary.
//   * Stash (the backward's recompute): per point [h_0 .. h_{L-1} | hf | dd
//     | encode | dir encode] at the compute dtype, the fused render stash
//     plus DKP columns, bit for bit what the products consumed.
// At bf16 and the served widths the inference forward runs the wgmma
// kernel instead (fused_mlp_fwd_wgmma.cuh, mlp_variant in
// ops/fused_mlp.py); this one keeps fp32, other widths, and the forward and
// stash form of training (route C), whose backward recomputes this
// kernel's bits.

#pragma once

#include "fused_render_common.cuh"

namespace {

struct MArgs {
  const float* xyz;     // (M, 3) sample points
  const float* dirb;    // (n_dirs, DK) dir encode at the compute dtype
  float* feat;          // (M, C), or null: not written
  float* sig;           // (M), or null: not written
  void* stash;          // (M, SC) at the compute dtype, or null
  const float* wsrow;   // (WP) sigma weights, fp32, unrounded
  const float* bs;
  const void* wf; const float* bf;    // xyz_encoding_final (WP x WP)
  const void* wdh; const float* bd;   // dir_encoding, hidden rows (WP x HP)
  const void* wde;                    // dir_encoding, encode rows (DKP x HP)
  const void* wc; const float* bc;    // feature head (HP x CP)
  const void* wenc[MAXL];             // encode rows of layer i (KE x WP)
  const void* wh[MAXL];               // hidden rows of layer i (WP x WP)
  const float* b[MAXL];
  int M, R, p_base, L, skip_mask, WP, HP, CP, C, KE, F, DK, DKP, exact, SC;
};

// zs[r] = sum_k A[r][k] * w[k] in fp32 for the tile's CH rows: warp w takes
// rows 8w .. 8w+7, lane l the columns l, l+32, ..; a shuffle tree sums.
template <typename T>
__device__ __forceinline__ void rowdot_f32(const T* A, int lda, int K,
                                           const float* __restrict__ w,
                                           float bias, float* zs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp * (CH / 8); r < (warp + 1) * (CH / 8); ++r) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32)
      s += to_f<T>(A[r * lda + k]) * __ldg(w + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) zs[r] = s + bias;
  }
}

template <bool BF16, bool STASH>
__global__ void __launch_bounds__(NTHREADS, BF16 ? 2 : 1)
    mlp_fwd_kernel(const MArgs a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int F = a.F;
  const int lde = a.KE + PAD, ldd = a.DKP + PAD, lda = a.WP + PAD;

  T* enc = reinterpret_cast<T*>(smem);
  T* denc = enc + CH * lde;
  T* act0 = denc + CH * ldd;
  T* act1 = act0 + CH * lda;
  float* feat = reinterpret_cast<float*>(act1 + CH * lda);
  float* sig = feat + CH * a.CP;
  float* xyz = sig + CH;       // CH * 3

  const int p0 = blockIdx.x * CH;
  const int nrows = min(CH, a.M - p0);
  // this tile's rows of the stash (only dereferenced under STASH)
  T* srow = static_cast<T*>(a.stash) + (size_t)p0 * a.SC;

  // the points; rows past M repeat the last point
  for (int i = tid; i < CH * 3; i += NTHREADS) {
    const int r = i / 3, c = i % 3;
    const float x = a.xyz[(size_t)min(p0 + r, a.M - 1) * 3 + c];
    xyz[i] = x;
    enc[r * lde + c] = to_t<T>(x);
  }
  // each row's direction encode
  for (int i = tid; i < CH * a.DKP; i += NTHREADS) {
    const int r = i / a.DKP, e = i % a.DKP;
    const int dir = (a.p_base + min(p0 + r, a.M - 1)) / a.R;
    denc[r * ldd + e] =
        to_t<T>(e < a.DK ? a.dirb[(size_t)dir * a.DK + e] : 0.f);
  }
  encode_tile<T>(enc, lde, xyz, F, a.KE, a.exact);
  if constexpr (STASH) {
    T* senc = srow + (a.L + 1) * a.WP + a.HP;
    store_rows<T>(senc, a.SC, enc, lde, a.KE, nrows);
    store_rows<T>(senc + a.KE, a.SC, denc, ldd, a.DKP, nrows);
  }

  const T* h = trunk_tile<BF16, STASH, T>(
      enc, lde, a.KE, act0, act1, lda, a.WP, a.L, a.skip_mask, a.wenc, a.wh,
      a.b, srow, a.SC, nrows);
  T* spare = (h == act0) ? act1 : act0;
  // sigma head in fp32, and xyz_encoding_final
  rowdot_f32<T>(h, lda, a.WP, a.wsrow, a.bs[0], sig);
  {
    const float* bf = a.bf;
    auto epi_f = [&](int r, int c, float v0, float v1) {
      store2<T>(spare + r * lda + c, v0 + bf[c], v1 + bf[c + 1]);
    };
    gemm<BF16, T>(h, lda, a.WP, a.wf, (const T*)nullptr, 0, 0, nullptr, a.WP,
                  epi_f);
  }
  __syncthreads();
  if constexpr (STASH)
    store_rows<T>(srow + a.L * a.WP, a.SC, spare, lda, a.WP, nrows);
  // dir layer: relu([hf | dir encode] @ [W_dh ; W_de] + b_d) into the trunk
  // buffer
  {
    T* ddb = const_cast<T*>(h);
    const float* bd = a.bd;
    auto epi_d = [&](int r, int c, float v0, float v1) {
      store2<T>(ddb + r * lda + c, fmaxf(v0 + bd[c], 0.f),
                fmaxf(v1 + bd[c + 1], 0.f));
    };
    gemm<BF16, T>(spare, lda, a.WP, a.wdh, denc, ldd, a.DKP, a.wde, a.HP,
                  epi_d);
  }
  __syncthreads();
  if constexpr (STASH)
    store_rows<T>(srow + (a.L + 1) * a.WP, a.SC, h, lda, a.HP, nrows);
  if (a.feat == nullptr && a.sig == nullptr) return;
  // feature head: sigmoid(dd @ W_c + b_c), fp32
  {
    const float* bc = a.bc;
    const int cp = a.CP;
    auto epi_c = [&](int r, int c, float v0, float v1) {
      feat[r * cp + c] = sigmoidf(v0 + bc[c]);
      feat[r * cp + c + 1] = sigmoidf(v1 + bc[c + 1]);
    };
    gemm<BF16, T>(h, lda, a.HP, a.wc, (const T*)nullptr, 0, 0, nullptr, a.CP,
                  epi_c);
  }
  __syncthreads();
  if (a.feat != nullptr) {
    float* fo = a.feat + (size_t)p0 * a.C;
    for (int i = tid; i < nrows * a.C; i += NTHREADS)
      fo[i] = feat[(i / a.C) * a.CP + i % a.C];
  }
  if (a.sig != nullptr && tid < nrows) a.sig[p0 + tid] = softplusf(sig[tid]);
}

size_t mlp_fwd_smem_bytes(const MArgs& a, bool bf16) {
  const size_t esz = bf16 ? 2 : 4;
  const size_t t_elems = (size_t)CH * (a.KE + PAD) +
                         (size_t)CH * (a.DKP + PAD) +
                         2 * (size_t)CH * (a.WP + PAD);
  const size_t f_elems = (size_t)CH * a.CP + CH + 3 * CH;
  return t_elems * esz + f_elems * 4;
}

template <bool BF16, bool STASH>
void mlp_fwd_launch(const MArgs& a, size_t smem, cudaStream_t st) {
  cudaFuncSetAttribute(mlp_fwd_kernel<BF16, STASH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  mlp_fwd_kernel<BF16, STASH>
      <<<(a.M + CH - 1) / CH, NTHREADS, smem, st>>>(a);
}

constexpr int MLP_FWD_PTRS = 14;   // pointers before the per-layer triples
constexpr int MLP_FWD_DIMS = 16;

// ptrs (host array): xyz, dirb, feat (0: not written), sig (0: not written),
// stash (0: none), wsrow, bs, wf, bf, wdh, bd, wde, wc, bc, then per trunk
// layer (wenc, wh, b); absent operands are 0.
// dims: M, R (points per direction), p_base (index of xyz[0] among all the
// points, for the direction lookup), L, skip_mask, WP, HP, CP, C, KE, F, DK,
// DKP, exact, BF16, SC.
// Fills a and bf16; returns 0, or cudaErrorInvalidValue for arguments the
// kernels do not take.
int parse_mlp_args(const void* const* ptrs, int n_ptrs, const int* dims,
                   int n_dims, MArgs& a, bool& bf16) {
  if (n_dims != MLP_FWD_DIMS) return (int)cudaErrorInvalidValue;
  a = MArgs{};
  a.M = dims[0]; a.R = dims[1]; a.p_base = dims[2]; a.L = dims[3];
  a.skip_mask = dims[4]; a.WP = dims[5]; a.HP = dims[6]; a.CP = dims[7];
  a.C = dims[8]; a.KE = dims[9]; a.F = dims[10]; a.DK = dims[11];
  a.DKP = dims[12]; a.exact = dims[13];
  bf16 = dims[14] != 0;
  a.SC = dims[15];
  if (a.M < 1 || a.R < 1 || a.p_base < 0 || a.L < 1 || a.L > MAXL)
    return (int)cudaErrorInvalidValue;
  if (n_ptrs != MLP_FWD_PTRS + 3 * a.L) return (int)cudaErrorInvalidValue;
  if (a.WP % 32 || a.WP > 32 * MAX_NTW || a.HP % 32 || a.HP > a.WP ||
      a.CP % 32 || a.CP > a.WP || a.C > a.CP || a.C < 1 || a.KE % 16 ||
      a.KE < 3 + 6 * a.F || a.F < 1 || a.F > 30 || a.DKP % 16 ||
      a.DK > a.DKP || a.DK < 1)
    return (int)cudaErrorInvalidValue;
  a.xyz = (const float*)ptrs[0]; a.dirb = (const float*)ptrs[1];
  a.feat = (float*)ptrs[2]; a.sig = (float*)ptrs[3];
  a.stash = const_cast<void*>(ptrs[4]);
  a.wsrow = (const float*)ptrs[5]; a.bs = (const float*)ptrs[6];
  a.wf = ptrs[7]; a.bf = (const float*)ptrs[8];
  a.wdh = ptrs[9]; a.bd = (const float*)ptrs[10];
  a.wde = ptrs[11];
  a.wc = ptrs[12]; a.bc = (const float*)ptrs[13];
  if (!a.xyz || !a.dirb) return (int)cudaErrorInvalidValue;
  for (int i = 5; i < MLP_FWD_PTRS; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  if (a.stash && a.SC != (a.L + 1) * a.WP + a.HP + a.KE + a.DKP)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.L; ++i) {
    a.wenc[i] = ptrs[MLP_FWD_PTRS + 3 * i];
    a.wh[i] = ptrs[MLP_FWD_PTRS + 1 + 3 * i];
    a.b[i] = (const float*)ptrs[MLP_FWD_PTRS + 2 + 3 * i];
    const bool with_enc = i == 0 || ((a.skip_mask >> i) & 1);
    if ((with_enc && !a.wenc[i]) || (i > 0 && !a.wh[i]) || !a.b[i])
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Arguments as parse_mlp_args takes them. Launches on ``stream`` and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernel does not take).
int mlp_fwd_entry(const void* const* ptrs, int n_ptrs, const int* dims,
                  int n_dims, void* stream) {
  MArgs a;
  bool bf16;
  const int rc = parse_mlp_args(ptrs, n_ptrs, dims, n_dims, a, bf16);
  if (rc != 0) return rc;
  const size_t smem = mlp_fwd_smem_bytes(a, bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (a.stash) mlp_fwd_launch<true, true>(a, smem, st);
    else mlp_fwd_launch<true, false>(a, smem, st);
  } else {
    if (a.stash) mlp_fwd_launch<false, true>(a, smem, st);
    else mlp_fwd_launch<false, false>(a, smem, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace
