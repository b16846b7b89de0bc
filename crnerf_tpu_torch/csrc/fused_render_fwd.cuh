// Fused volume rendering forward for one pass: positional encode, NeRF MLP
// (trunk with skip, sigma / final / dir / feature heads) and alpha
// compositing in ONE kernel. Only per-ray results leave it: ray block
// [feature map | depth | 0] (N, ldo) f32 and weights (N, S) f32. Two input
// forms: rays-in (xyz = o + d*z made here from per-ray origins, directions
// and z) and xyz-in (a coordinate per sample point is read, 12 bytes a
// point, where the caller jittered the points; depth still uses z).
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_fwd_kernel (the
// Pallas TPU kernel, forward; rays_in=True and rays_in=False, where the TPU
// kernel streams an encode built outside and this one encodes the points it
// reads; stash=False, and stash=True when a stash pointer is given: the
// same body with extra stores). Included by fused_render_fwd.cu (the
// forward's library) and by fused_render_bwd_recompute.cu, whose backward
// runs the stash instantiation slab by slab.
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
//   * Encode (encode_tile, fused_render_common.cuh): sinf/cosf of x * 2^k
//     or the anchored double-angle recurrence; rounding-exact intrinsics
//     keep the compiler from fusing o + d*z into an FMA the plain version
//     does not use.
//   * Stash (training): every chunk's encode, trunk ReLU outputs, hf and
//     dd are copied from shared memory to one row per point of the stash,
//     [h_0 .. h_{L-1} | hf | dd | encode] at the compute dtype, bit for
//     bit what the products consumed. ~5 KB per point at 8x256 bf16: with
//     it the kernel also moves bytes, ~4 KB per MFLOP, still under the
//     card's operations-per-byte line.
// The chunk's heads (heads_tile), its compositing (composite_chunk), the
// per-row scalars and the argument parsing are shared with the pipelined
// forward (pipe_render_fwd.cu), which runs them with the compositing on a
// warp of its own.
// The forward at bf16 and the served widths, with or without the stash,
// has a wgmma / TMA counterpart (fused_render_fwd_wgmma.cuh), chosen by
// shape in ops/fused_render.py render_variant; this kernel keeps fp32,
// other widths, the no-stash training forwards (routes A and B: their
// recompute must give the forward's bits) and the recompute backward's
// stash form.

#pragma once

#include "fused_render_common.cuh"

namespace {

struct KArgs {
  const float* od;      // (N, 8) [o | d | pad]; unused when xyz is given
  const float* xyz;     // (N*S, 3) sample points, or null: rays-in
  const float* z;       // (N, S)
  const float* noise;   // (N, S)
  const float* dirb;    // (N, DK) dir encode at the compute dtype
  float* out;           // (N, ldo), or null: not written
  float* wout;          // (N, S), or null: not written
  const void* ws; const float* bs;    // sigma head (WP x 32)
  const void* wf; const float* bf;    // xyz_encoding_final (WP x WP)
  const void* wdh; const float* bd;   // dir_encoding, hidden rows (WP x HP)
  const float* wde;                   // dir_encoding, encode rows (DK x HP)
  const void* wc; const float* bc;    // feature head (HP x CP)
  const void* wenc[MAXL];             // encode rows of layer i (KE x WP)
  const void* wh[MAXL];               // hidden rows of layer i (WP x WP)
  const float* b[MAXL];
  void* stash;          // (N*S, SC) at the compute dtype, or null
  int N, S, L, skip_mask, WP, HP, CP, C, KE, F, DK, exact, ldo, SC;
};

// -------------------------------------------------- the chunk's stages
// z, noise and delta of sample j of a ray of S samples; rows past S repeat
// the last sample's z and get noise 0 (and alpha 0 in composite_chunk).
__device__ __forceinline__ void row_scalars(const float* zr, const float* nr,
                                            int S, int j, float& zc,
                                            float& nz, float& dl) {
  const int jc = j < S ? j : S - 1;
  const float zj = zr[jc];
  zc = zj;
  nz = j < S ? nr[j] : 0.f;
  dl = j < S - 1 ? zr[j + 1] - zj : DELTA_INF;
}

// The heads over a chunk after the trunk (h: its last layer, in act0 or
// act1): sigma (column 0 of a 32-wide product) into sig, hf = h @ W_f +
// b_f into the other activation buffer, dd = relu(hf @ W_dh + dir term +
// b_d) into h's buffer, the features sigmoid(dd @ W_c + b_c) into feat
// (fp32). After each stage, past its barrier (warps_sync<BAR>), after(k,
// buffer) runs: k = 0 with hf, 1 with dd, 2 with the features complete.
template <bool BF16, int BAR, typename T, class After>
__device__ __forceinline__ void heads_tile(const KArgs& a, const T* h,
                                           T* act0, T* act1, int lda,
                                           const float* dirt, float* sig,
                                           float* feat, After after) {
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
  warps_sync<BAR>();
  after(0, (const T*)spare);
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
  warps_sync<BAR>();
  after(1, h);
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
  warps_sync<BAR>();
  after(2, (const T*)nullptr);
}

// Compositing of the chunk starting at sample c0 by one warp, two rows per
// lane (rows 2 lane, 2 lane + 1 of sig, nz, dl and zc): the weights into
// wts (and into wo, the ray's row of the weights output, unless null), the
// transmittance carried from chunk to chunk as a running product, the
// chunk's depth added to dep. Every lane ends with the same t_carry and dep.
__device__ __forceinline__ void composite_chunk(
    const float* sig, const float* nz, const float* dl, const float* zc,
    int c0, int S, int lane, float* wts, float* wo, float& t_carry,
    float& dep) {
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
  if (wo != nullptr) {
    if (c0 + r0 < S) wo[c0 + r0] = w0;
    if (c0 + r0 + 1 < S) wo[c0 + r0 + 1] = w1;
  }
  float pd = w0 * zc[r0] + w1 * zc[r0 + 1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pd += __shfl_xor_sync(0xffffffffu, pd, off);
  dep += pd;
}

// ------------------------------------------------------------- kernel
template <bool BF16, bool STASH>
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

  const float* xr = a.xyz ? a.xyz + (size_t)ray * S * 3 : nullptr;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  if (xr == nullptr) {
    const float* od = a.od + (size_t)ray * 8;
    o[0] = od[0]; o[1] = od[1]; o[2] = od[2];
    d[0] = od[3]; d[1] = od[4]; d[2] = od[5];
  }
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
    // this chunk's rows of the stash (only dereferenced under STASH)
    T* srow = static_cast<T*>(a.stash) + ((size_t)ray * S + c0) * a.SC;
    const int nrows = min(CH, S - c0);
    // per-row scalars; rows past S repeat the last sample and get alpha 0
    if (tid < CH) row_scalars(zr, nr, S, c0 + tid, zc[tid], nz[tid], dl[tid]);
    __syncthreads();
    // encode: [x, sin 2^0 x, cos 2^0 x, sin 2^1 x, ...] interleaved
    for (int i = tid; i < CH * 3; i += NTHREADS) {
      const int r = i / 3, c = i % 3;
      const float x = xr ? xr[min(c0 + r, S - 1) * 3 + c]
                         : __fadd_rn(o[c], __fmul_rn(d[c], zc[r]));
      xyz[i] = x;
      enc[r * lde + c] = to_t<T>(x);
    }
    encode_tile<T>(enc, lde, xyz, F, a.KE, a.exact);
    if constexpr (STASH)
      store_rows<T>(srow + (a.L + 1) * a.WP + a.HP, a.SC, enc, lde, a.KE,
                    nrows);

    const T* h = trunk_tile<BF16, STASH, T>(
        enc, lde, a.KE, act0, act1, lda, a.WP, a.L, a.skip_mask, a.wenc, a.wh,
        a.b, srow, a.SC, nrows);
    heads_tile<BF16, 0, T>(
        a, h, act0, act1, lda, dirt, sig, feat,
        [&](int stage, const T* buf) {
          if constexpr (STASH) {
            if (stage == 0)        // hf
              store_rows<T>(srow + a.L * a.WP, a.SC, buf, lda, a.WP, nrows);
            else if (stage == 1)   // dd
              store_rows<T>(srow + (a.L + 1) * a.WP, a.SC, buf, lda, a.HP,
                            nrows);
          }
        });

    // compositing of the chunk: warp 0, two rows per lane
    if (warp == 0)
      composite_chunk(sig, nz, dl, zc, c0, S, lane, wts,
                      a.wout ? a.wout + (size_t)ray * S : nullptr, t_carry,
                      dep);
    __syncthreads();
    if (tid < a.C) {
      for (int r = 0; r < CH; ++r) fm += wts[r] * feat[r * a.CP + tid];
    }
  }
  if (a.out == nullptr) return;
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

template <bool BF16, bool STASH>
void launch(const KArgs& a, size_t smem, cudaStream_t st) {
  cudaFuncSetAttribute(render_fwd_kernel<BF16, STASH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  render_fwd_kernel<BF16, STASH><<<a.N, NTHREADS, smem, st>>>(a);
}

constexpr int FWD_PTRS = 17;   // pointers before the per-layer triples
constexpr int FWD_DIMS = 15;

// ptrs (host array): od (0 with xyz), z, noise, dirb, out (0: not written),
// wout (0: not written), stash (0: none), xyz (0: rays-in), ws, bs, wf, bf,
// wdh, bd, wde, wc, bc, then per trunk layer (wenc, wh, b); absent operands
// are 0.
// dims: N, S, L, skip_mask, WP, HP, CP, C, KE, F, DK, exact, ldo, BF16, SC.
// Fills a and bf16; returns 0, or cudaErrorInvalidValue for arguments the
// kernels do not take.
int parse_fwd_args(const void* const* ptrs, int n_ptrs, const int* dims,
                   int n_dims, KArgs& a, bool& bf16) {
  if (n_dims != FWD_DIMS) return (int)cudaErrorInvalidValue;
  a = KArgs{};
  a.N = dims[0]; a.S = dims[1]; a.L = dims[2]; a.skip_mask = dims[3];
  a.WP = dims[4]; a.HP = dims[5]; a.CP = dims[6]; a.C = dims[7];
  a.KE = dims[8]; a.F = dims[9]; a.DK = dims[10]; a.exact = dims[11];
  a.ldo = dims[12]; a.SC = dims[14];
  bf16 = dims[13] != 0;
  if (a.N < 1 || a.S < 1 || a.L < 1 || a.L > MAXL) return (int)cudaErrorInvalidValue;
  if (n_ptrs != FWD_PTRS + 3 * a.L) return (int)cudaErrorInvalidValue;
  if (a.WP % 32 || a.WP > 32 * MAX_NTW || a.HP % 32 || a.HP > a.WP ||
      a.CP % 32 || a.CP > 32 * MAX_NTW || a.C > a.CP || a.C >= a.ldo ||
      a.KE % 16 || a.KE < 3 + 6 * a.F || a.F < 1 || a.F > 30)
    return (int)cudaErrorInvalidValue;
  a.od = (const float*)ptrs[0]; a.z = (const float*)ptrs[1];
  a.noise = (const float*)ptrs[2]; a.dirb = (const float*)ptrs[3];
  a.out = (float*)ptrs[4]; a.wout = (float*)ptrs[5];
  a.stash = const_cast<void*>(ptrs[6]);
  a.xyz = (const float*)ptrs[7];
  a.ws = ptrs[8]; a.bs = (const float*)ptrs[9];
  a.wf = ptrs[10]; a.bf = (const float*)ptrs[11];
  a.wdh = ptrs[12]; a.bd = (const float*)ptrs[13];
  a.wde = (const float*)ptrs[14];
  a.wc = ptrs[15]; a.bc = (const float*)ptrs[16];
  if ((!a.od && !a.xyz) || !a.z || !a.noise || !a.dirb)
    return (int)cudaErrorInvalidValue;
  if (a.stash && a.SC != (a.L + 1) * a.WP + a.HP + a.KE)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.L; ++i) {
    a.wenc[i] = ptrs[FWD_PTRS + 3 * i];
    a.wh[i] = ptrs[FWD_PTRS + 1 + 3 * i];
    a.b[i] = (const float*)ptrs[FWD_PTRS + 2 + 3 * i];
    const bool with_enc = i == 0 || ((a.skip_mask >> i) & 1);
    if ((with_enc && !a.wenc[i]) || (i > 0 && !a.wh[i]) || !a.b[i])
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Arguments as parse_fwd_args takes them. Launches on ``stream`` and
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernel does not take).
int render_fwd_entry(const void* const* ptrs, int n_ptrs, const int* dims,
                     int n_dims, void* stream) {
  KArgs a;
  bool bf16;
  const int rc = parse_fwd_args(ptrs, n_ptrs, dims, n_dims, a, bf16);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(a, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (a.stash) launch<true, true>(a, smem, st);
    else launch<true, false>(a, smem, st);
  } else {
    if (a.stash) launch<false, true>(a, smem, st);
    else launch<false, false>(a, smem, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace
