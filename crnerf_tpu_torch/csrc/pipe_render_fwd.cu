// Pipelined fused render forward: K1's rays-in, no-stash forward
// (fused_render_fwd.cuh) with the compositing on a warp of its own, so that
// one chunk's compositing runs while the product warps work on the next
// chunk, of the same ray or of the CTA's next ray.
//
// Replaces the Pallas TPU kernel of scripts/spike_interleave.py:47
// (_make_pipe_fwd_kernel, reached from pipe_render_apply, pallas_call at
// :157). That kernel holds P half-tiles of r_half rays a grid step and
// orders its body encode-all, trunk-all, composite-all, hoping the TPU's
// VLIW core co-issues one half's encode with another half's matrix work. It
// computes exactly K1's function. On Hopper the stall to remove is another
// one: K1 composites each 64-sample chunk on warp 0 alone while its seven
// other warps wait at a barrier (PERF.md section 6).
//
// What bounds it: as K1, the tensor cores (~1.2 MFLOP of products per
// sample point at 8x256). Design:
//   * A CTA of 9 warps takes P consecutive rays (``phases``) and walks them
//     as one stream of 64-sample chunks. Warps 0-7 run encode, trunk and
//     heads with K1's code (encode_tile, trunk_tile, heads_tile) and K1's
//     bits; warp 8 runs composite_chunk and the feature-map sums, K1's
//     warp-0 and tid < C code, and writes each ray's row.
//   * The warps meet at named barriers, never at __syncthreads: the product
//     warps among themselves at barrier 1 (warps_sync<1>); they arrive at 2
//     when sigma is in ``sig`` and at 3 when the features are in ``feat``,
//     where the compositing warp waits; it arrives at 4 when it is done
//     with both, where the product warps wait before the next chunk's heads
//     (not before its encode and trunk, which is the overlap). Each barrier
//     is waited on once between two arrivals, so no phase is overtaken.
//   * P sets how many rays share one CTA's pipeline: with P = 1 the last
//     chunk's compositing of every ray finds no next chunk to overlap.
//     Shared memory does not depend on P (one ray's direction term at a
//     time), so every P fits where P = 1 does; ~100 KB at 8x256, KE = 96,
//     CP = 64: room for two CTAs an SM, as K1, were it not for registers
//     (below). The spike's r_half has no counterpart: a CTA walks its rays
//     in 64-sample chunks whatever their number.
//   * bf16 only (the spike runs bf16); the wrapper refuses fp32 on the card.
//   * The price is registers. An SM splits its 64K registers between four
//     sub-partitions and places a CTA's warps round robin; two CTAs of nine
//     warps would put five warps on one sub-partition and cap a thread at
//     96 registers, where K1's trunk takes 128 (two CTAs of eight warps:
//     four a sub-partition, 128 each). Built so, the kernel spilled and ran
//     3.4x slower than K1 (PERF.md section 6), so it is built for one CTA an
//     SM: up to 168 registers a thread (three warps a sub-partition).

#include "fused_render_fwd.cuh"

namespace {

constexpr int PIPE_THREADS = NTHREADS + 32;
constexpr int BAR_MMA = 1;   // the product warps among themselves
constexpr int BAR_SIG = 2;   // sigma of a chunk in sig
constexpr int BAR_FEAT = 3;  // the features of a chunk in feat
constexpr int BAR_FREE = 4;  // the compositing warp is done with sig, feat
constexpr int MAX_CQ = 4;    // feature channels a lane of warp 8 sums (C <= 128)

template <int ID>
__device__ __forceinline__ void pipe_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(PIPE_THREADS) : "memory");
}

// Arrive without waiting; the writes before it are made visible to the
// CTA first.
template <int ID>
__device__ __forceinline__ void pipe_arrive() {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(PIPE_THREADS)
               : "memory");
}

// K1's shared memory and one more row of z for the compositing warp.
size_t pipe_smem_bytes(const KArgs& a) {
  return smem_bytes(a, true) + (size_t)CH * 4;
}

__global__ void __launch_bounds__(PIPE_THREADS, 1)
    pipe_render_fwd_kernel(const KArgs a, int P) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, F = a.F;
  const int lde = a.KE + PAD, lda = a.WP + PAD;
  const int ray0 = blockIdx.x * P;
  const int n_rays = min(P, a.N - ray0);
  const int n_chunks = (S + CH - 1) / CH;

  T* enc = reinterpret_cast<T*>(smem);
  T* act0 = enc + CH * lde;
  T* act1 = act0 + CH * lda;
  float* feat = reinterpret_cast<float*>(act1 + CH * lda);
  float* sig = feat + CH * a.CP;
  float* zc = sig + CH;        // product warps: z of the chunk's rows
  float* nz = zc + CH;         // compositing warp: noise, delta, weights
  float* dl = nz + CH;
  float* wts = dl + CH;
  float* xyz = wts + CH;       // CH * 3
  float* dirt = xyz + CH * 3;  // HP
  float* zcc = dirt + a.HP;    // compositing warp: z of the chunk's rows

  if (warp < NTHREADS / 32) {
    for (int p = 0; p < n_rays; ++p) {
      const int ray = ray0 + p;
      const float* od = a.od + (size_t)ray * 8;
      const float o[3] = {od[0], od[1], od[2]};
      const float d[3] = {od[3], od[4], od[5]};
      const float* zr = a.z + (size_t)ray * S;
      // the dir term of this ray: the last reader of the previous ray's
      // (its last chunk's heads) is past heads_tile's final barrier
      for (int n = tid; n < a.HP; n += NTHREADS) {
        const float* db = a.dirb + (size_t)ray * a.DK;
        float s = 0.f;
        for (int e = 0; e < a.DK; ++e) s += db[e] * a.wde[e * a.HP + n];
        dirt[n] = s;
      }
      for (int c0 = 0; c0 < S; c0 += CH) {
        if (tid < CH) zc[tid] = zr[min(c0 + tid, S - 1)];
        warps_sync<BAR_MMA>();
        for (int i = tid; i < CH * 3; i += NTHREADS) {
          const int r = i / 3, c = i % 3;
          const float x = __fadd_rn(o[c], __fmul_rn(d[c], zc[r]));
          xyz[i] = x;
          enc[r * lde + c] = to_t<T>(x);
        }
        encode_tile<T, BAR_MMA>(enc, lde, xyz, F, a.KE, a.exact);
        const T* h = trunk_tile<true, false, T, BAR_MMA>(
            enc, lde, a.KE, act0, act1, lda, a.WP, a.L, a.skip_mask, a.wenc,
            a.wh, a.b, (T*)nullptr, a.SC, 0);
        // sig and feat are free once the previous chunk is composited
        if (p > 0 || c0 > 0) pipe_sync<BAR_FREE>();
        heads_tile<true, BAR_MMA, T>(a, h, act0, act1, lda, dirt, sig, feat,
                                     [&](int stage, const T*) {
                                       if (stage == 0) pipe_arrive<BAR_SIG>();
                                       if (stage == 2)
                                         pipe_arrive<BAR_FEAT>();
                                     });
      }
    }
    return;
  }

  // warp 8: compositing and the feature-map sums, chunk after chunk
  const int total = n_rays * n_chunks;
  int g = 0;
  for (int p = 0; p < n_rays; ++p) {
    const int ray = ray0 + p;
    const float* zr = a.z + (size_t)ray * S;
    const float* nr = a.noise + (size_t)ray * S;
    float* wo = a.wout + (size_t)ray * S;
    float t_carry = 1.f, dep = 0.f;
    float fm[MAX_CQ] = {0.f, 0.f, 0.f, 0.f};  // channel lane + 32 q
    for (int c0 = 0; c0 < S; c0 += CH) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 2 * lane + q;
        row_scalars(zr, nr, S, c0 + r, zcc[r], nz[r], dl[r]);
      }
      pipe_sync<BAR_SIG>();
      composite_chunk(sig, nz, dl, zcc, c0, S, lane, wts, wo, t_carry, dep);
      __syncwarp();
      pipe_sync<BAR_FEAT>();
#pragma unroll
      for (int q = 0; q < MAX_CQ; ++q) {
        const int c = lane + 32 * q;
        if (c < a.C)
          for (int r = 0; r < CH; ++r) fm[q] += wts[r] * feat[r * a.CP + c];
      }
      __syncwarp();
      if (++g < total) pipe_arrive<BAR_FREE>();
    }
    float* orow = a.out + (size_t)ray * a.ldo;
#pragma unroll
    for (int q = 0; q < 8; ++q) {   // ldo <= 256
      const int c = lane + 32 * q;
      if (c < a.ldo) {
        float v = 0.f;
        if (q < MAX_CQ && c < a.C) v = fm[q < MAX_CQ ? q : 0];
        if (c == a.C) v = dep;
        orow[c] = v;
      }
    }
  }
}

// What this kernel takes beyond K1's dims: bf16, C <= 128 (four channels
// a lane of warp 8), ldo <= 256.
bool pipe_dims_ok(const KArgs& a, bool bf16) {
  return bf16 && a.C <= 32 * MAX_CQ && a.ldo <= 256;
}

// CTAs of the kernel one SM holds with ``smem`` bytes of shared memory into
// *blocks; 0 when a CTA may not have that much.
int occupancy(size_t smem, int* blocks) {
  if (cudaFuncSetAttribute(pipe_render_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    cudaGetLastError();   // more shared memory than a CTA may have
    return 0;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pipe_render_fwd_kernel, PIPE_THREADS, smem);
}

constexpr int PIPE_DIMS = FWD_DIMS + 1;

}  // namespace

// ptrs as parse_fwd_args takes them, rays-in with both outputs and no
// stash; dims: its 15 dims, then P (rays a CTA, >= 1). bf16 only. Launches on
// ``stream``; returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int crnerf_pipe_render_fwd(const void* const* ptrs, int n_ptrs,
                                      const int* dims, int n_dims,
                                      void* stream) {
  if (n_dims != PIPE_DIMS) return (int)cudaErrorInvalidValue;
  KArgs a;
  bool bf16;
  const int rc = parse_fwd_args(ptrs, n_ptrs, dims, FWD_DIMS, a, bf16);
  if (rc != 0) return rc;
  const int P = dims[FWD_DIMS];
  if (!pipe_dims_ok(a, bf16) || P < 1 || a.stash || a.xyz || !a.od ||
      !a.out || !a.wout)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pipe_smem_bytes(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(pipe_render_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  pipe_render_fwd_kernel<<<(a.N + P - 1) / P, PIPE_THREADS, smem, st>>>(a, P);
  return (int)cudaGetLastError();
}

// CTAs of the kernel one SM holds at these dims (as crnerf_pipe_render_fwd
// takes them; P does not change it) into *blocks, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 when a CTA does not fit.
extern "C" int crnerf_pipe_render_occupancy(const int* dims, int n_dims,
                                            int* blocks) {
  if (n_dims != PIPE_DIMS || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  KArgs a = {};
  a.WP = dims[4]; a.HP = dims[5]; a.CP = dims[6]; a.KE = dims[8];
  *blocks = 0;
  return occupancy(pipe_smem_bytes(a), blocks);
}
