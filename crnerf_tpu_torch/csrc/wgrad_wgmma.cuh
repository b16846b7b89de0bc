// K2's weight gradient on Hopper: dW = A^T dZ over the sample points for
// every weight of the NeRF MLP, A a column block of the stash and dZ one of
// the dz buffer (both bf16, one row a point), fp32 sums; the same function
// as wgrad_bf16_kernel (fused_render_bwd.cuh), with its products on wgmma
// and its operands brought in by TMA. And the entry every caller of the
// weight gradient goes through, which picks the kernel.
//
// Replaces the weight-gradient half of
// crnerf_tpu/ops/fused_render.py:_make_render_bwd_stash_kernel (the Pallas
// TPU kernel's dwargs pallas_calls) for the shape wgrad_variant
// (ops/fused_render.py) gives to it: bf16 at the served MLPs' widths
// (WP = 256, HP = 128, CP = 64). Its callers: the stash route's backward
// (fused_render_bwd.cu), every slab of the recompute backward
// (fused_render_bwd_recompute.cu) and of the per-point backward
// (fused_mlp_bwd.cu). fp32 (wgrad_f32_kernel) and other bf16 widths
// (wgrad_bf16_kernel) stay as they are.
//
// What bounds it: at 8x256 each point brings 5,056 bf16 of stash and dz
// (10 KB) into ~2.5 MFLOP of products, ~250 operations a byte, under the
// card's ~295: device memory (6.33 ms at 16,384 x 128 on an H100 SXM). So
// each operand byte should come from device memory about once, with
// enough bytes in flight to keep it busy. Design:
//   * A CTA owns one output tile, 128 rows (stash columns) x the job's
//     whole dz width N (256, 128 or 64: a template parameter of its
//     products; the sigma job's 32 columns run at 64 and store 32), and one
//     split of the points. The mma.sync kernel cut a 256-wide job into
//     2 x 2 tiles of 128, so it read every stash block and every dz block
//     twice; here each stash block is read once, and the tiles are half as
//     many (23 at 8x256).
//   * A producer warpgroup's one lane loads, per stage of 64 points, two
//     TMA boxes of the stash (64 points x 64 columns, 128-byte swizzled,
//     through a 2-D tensor map over the stash rows) and N / 64 boxes of dz
//     into an NS-stage mbarrier ring (NS = 4 at N = 256: 192 KB in flight
//     a CTA). A box past the row's end or past the last point is
//     zero-filled by the map; columns past a job's own (the encode's 96
//     rows in a 128-row tile, the sigma job's 32 columns) are read and not
//     stored.
//   * Two consumer warpgroups (setmaxnreg 232; the producer 40) own 64
//     output rows each and run wgmma m64nNk16 with both operands MN-major,
//     the boxes as they lie: the 64 points of a stage are the reduction.
//     A 64 x 256 fp32 accumulator is 128 registers a thread.
//   * Clusters of two CTAs, one CTA an SM: the two 128-row halves of a
//     256-row job (the pair table, ops/fused_render.py _pair_table) run
//     side by side on the same points, and each of their dz boxes is
//     loaded once, by one CTA into both (TMA multicast; a slot is then
//     released on both CTAs); the 128-row jobs go two by two, the two
//     encode jobs sharing their stash boxes the same way. Left to the L2
//     alone (the same clusters with no box shared), the second reads came
//     from device memory (tools/wgrad_ab on an H100 at 700 W: 13.35 ms
//     against 9.96 at 16,384 x 128).
//     The grid is (split, tile), tiles of a split adjacent in block order,
//     about two waves of items: the partials stay under the mma.sync
//     kernel's, and eight waves were no faster (tools/wgrad_ab).
//   * Each CTA writes its partial tile; reduce_partials sums the splits in
//     index order, onto what wout holds with ``accumulate``. No atomics:
//     two runs on the same inputs give the same bits. The sums run in
//     another order than the mma.sync kernel's (other splits, wgmma's own
//     accumulation), so the two agree to the fp32 rounding of ~1e5-term
//     sums, not to the bit.
// Left for later: fusing the weight gradient into the chain so that dz
// never reaches device memory (fused_render_bwd.cuh).

#pragma once

#include "fused_render_bwd.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int WW_PTS = 64;               // points a stage: a box's rows
constexpr int WW_BOX = WW_PTS * 128;     // one box: 64 points x 64 bf16
constexpr int WW_A = 2;                  // stash boxes a stage: 128 rows

template <int N>
__host__ __device__ constexpr int ww_stage() {
  return (WW_A + N / 64) * WW_BOX;
}

template <int N>
__host__ __device__ constexpr int ww_slots() {
  constexpr int n = (WG_SMEM_MAX - 2048) / ww_stage<N>();
  return n < WG_MAX_NS ? n : WG_MAX_NS;
}

constexpr int ww_max(int a, int b) { return a > b ? a : b; }

// 1024 to align, the barriers, the ring of the widest use
constexpr int WW_SMEM =
    2048 + ww_max(ww_max(ww_slots<64>() * ww_stage<64>(),
                         ww_slots<128>() * ww_stage<128>()),
                  ww_slots<256>() * ww_stage<256>());
static_assert(WW_SMEM <= WG_SMEM_MAX, "shared memory");

// The producer lane: nsteps stages of 64 points from point m_begin on.
// share_a / share_b: the cluster peer takes the same stash / dz boxes (a
// job's other 128 rows share its dz, two encode jobs share the encode);
// each CTA loads every other one into both.
template <int N>
__device__ __forceinline__ void ww_produce(const CUtensorMap* amap,
                                           const CUtensorMap* dmap,
                                           const Tile& tl, int m_begin,
                                           int nsteps, bool share_a,
                                           bool share_b, uint32_t rank,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty) {
  constexpr int STAGE = ww_stage<N>();
  constexpr int NS = ww_slots<N>();
  Ring rg;
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    mbar_wait(&empty[rg.s], rg.ph ^ 1);
    mbar_expect_tx(&full[rg.s], STAGE);
    uint8_t* st = ring + rg.s * STAGE;
    const int p0 = m_begin + s * WW_PTS;
#pragma unroll 1
    for (int j = 0; j < WW_A + N / 64; ++j) {
      const bool is_a = j < WW_A;
      const CUtensorMap* map = is_a ? amap : dmap;
      const int col = is_a ? tl.a_col + 64 * j : tl.b_col + 64 * (j - WW_A);
      if (!(is_a ? share_a : share_b))
        tma_load_2d(st + j * WW_BOX, map, &full[rg.s], col, p0);
      else if ((j & 1) == (int)rank)
        tma_load_2d_multicast(st + j * WW_BOX, map, &full[rg.s], col, p0,
                              0x3);
    }
    rg.next<NS>();
  }
}

// A consumer warpgroup: its 64 rows of the tile over nsteps stages, then
// its rows (< k_valid) and columns (< n_valid) of the partial into out.
// With ``share`` a slot is released on both CTAs of the cluster (both
// load into it).
template <int N>
__device__ __forceinline__ void ww_consume(const Tile& tl, float* out,
                                           int nsteps, bool share,
                                           uint32_t peer, uint8_t* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int g, int warp, int lane,
                                           bool leader) {
  constexpr int STAGE = ww_stage<N>();
  constexpr int NS = ww_slots<N>();
  const uint32_t ring_a = smem_u32(ring);
  Ring rg;
  float acc[N / 2];
  zero_acc(acc);
  wg_product<N, NS, STAGE, WW_BOX>(
      acc, nsteps, [&](int) { return ring_a + rg.s * STAGE + g * WW_BOX; },
      ring_a + WW_A * WW_BOX, full, empty, rg, leader,
      [&](uint64_t* bar) {
        mbar_arrive(bar);
        if (share) mbar_arrive_cluster(bar, peer);
      });
  const int r0 = g * WG_ROWS + warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const int c = nb * 8 + cq;
    if (c >= tl.n_valid) continue;
    if (r0 < tl.k_valid)
      *reinterpret_cast<float2*>(out + (size_t)r0 * tl.ld_out + c) =
          make_float2(acc[nb * 4], acc[nb * 4 + 1]);
    if (r0 + 8 < tl.k_valid)
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * tl.ld_out + c) =
          make_float2(acc[nb * 4 + 2], acc[nb * 4 + 3]);
  }
}

// Block b: tile b % n_tiles of the table (k_valid <= 128, n_valid <= 256;
// k_valid 0: nothing), split b / n_tiles, points [split * m_per, + m_per)
// (m_per a multiple of 64), its partial at part[split * WT + out_off ..].
// Clusters of two CTAs, tiles 2i and 2i + 1 of the table (n_tiles even):
// where both take the same dz (or stash) columns of the same width, each
// such box is loaded once for both (TMA multicast).
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap dmap,
                       const WArgs a, const int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WG_MAX_NS;
  uint8_t* ring = smem + 1024;
  const int t = blockIdx.x % n_tiles;
  const Tile tl = a.tiles[t], tp = a.tiles[t ^ 1];
  const uint32_t rank = cluster_rank();
  const int n = tl.n_valid <= 64 ? 64 : tl.n_valid <= 128 ? 128 : 256;
  const int n_peer = tp.n_valid <= 64 ? 64 : tp.n_valid <= 128 ? 128 : 256;
  // both busy, the same stage layout, the same columns
  const bool pair = tl.k_valid > 0 && tp.k_valid > 0 && n == n_peer;
  const bool share_a = pair && tl.a_col == tp.a_col;
  const bool share_b = pair && tl.b_col == tp.b_col;
  const bool share = share_a || share_b;
  const int split = blockIdx.x / n_tiles;
  const int m_begin = split * a.m_per;
  const int m_end = min(a.M, m_begin + a.m_per);
  const int nsteps = tl.k_valid > 0 && m_end > m_begin
                         ? (m_end - m_begin + WW_PTS - 1) / WW_PTS
                         : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WG_MAX_NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], share ? 4 : 2);
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (tid >= 256) {  // ----------------------------------------- producer
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (tid == 256) {
      if (n == 64)
        ww_produce<64>(&amap, &dmap, tl, m_begin, nsteps, share_a, share_b,
                       rank, ring, full, empty);
      else if (n == 128)
        ww_produce<128>(&amap, &dmap, tl, m_begin, nsteps, share_a, share_b,
                        rank, ring, full, empty);
      else
        ww_produce<256>(&amap, &dmap, tl, m_begin, nsteps, share_a, share_b,
                        rank, ring, full, empty);
    }
  } else {
    setmaxnreg_inc<WG_REGS_CONSUMER>();
    const int g = tid >> 7, wtid = tid & 127;
    const int warp = wtid >> 5, lane = tid & 31;
    float* out = a.part + (size_t)split * a.WT + tl.out_off;
    if (n == 64)
      ww_consume<64>(tl, out, nsteps, share, rank ^ 1, ring, full, empty, g,
                     warp, lane, wtid == 0);
    else if (n == 128)
      ww_consume<128>(tl, out, nsteps, share, rank ^ 1, ring, full, empty,
                      g, warp, lane, wtid == 0);
    else
      ww_consume<256>(tl, out, nsteps, share, rank ^ 1, ring, full, empty,
                      g, warp, lane, wtid == 0);
  }
  // no CTA leaves while its peer may still load into it or arrive on it
  cluster_sync();
}

// A bf16 matrix of m rows x cols columns, row-major, as a 2-D tensor map
// with 64-column x 64-row boxes in the 128-byte swizzle. Returns 0 or a
// CUresult.
int point_rows_map(CUtensorMap* map, const void* base, int m, int cols) {
  const long long dims[2] = {cols, m};
  const int box[2] = {64, WW_PTS};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, 2, dims,
                    box);
}

int wgrad_wgmma_launch(const WArgs& a, int n_tiles, int splits,
                       cudaStream_t st) {
  CUtensorMap amap = {}, dmap = {};
  int rc = point_rows_map(&amap, a.stash, a.M, a.SC);
  if (rc != 0) return rc;
  rc = point_rows_map(&dmap, a.dzbuf, a.M, a.DC);
  if (rc != 0) return rc;
  auto kern = wgrad_wgmma_kernel;
  const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WW_SMEM);
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * splits);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WW_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, amap, dmap, a, n_tiles);
}

// The weight-gradient kernels, as dims[7] names them
enum WgradKernel { WGRAD_FP32 = 0, WGRAD_MMA = 1, WGRAD_WGMMA = 2 };

// ptrs (host array): stash, dzbuf, tiles (n_tiles x 6 int32), part, wout.
// dims: M, SC, DC, WT, n_tiles, splits, m_per, kernel (WgradKernel: the
// fp32 kernel, bf16 on mma.sync, bf16 on wgmma).
// Launches the split-K weight-gradient kernel over (n_tiles, splits) CTAs,
// CTA (t, s) over points [s * m_per, (s + 1) * m_per), one partial a split
// into part (splits x WT), then the fixed-order sum of the splits into
// wout (WT), with ``accumulate`` onto what wout holds. The tile table is
// made for the kernel's tiles (ops/fused_render.py _WGRAD_TILES): 64 x 64
// at fp32, 128 x 128 on mma.sync; on wgmma 128 rows x the job's dz width
// (<= 256) in pairs (_pair_table: an even count), m_per a multiple of 64,
// the rows 16-byte aligned.
int render_bwd_wgrad_entry(const void* const* ptrs, int n_ptrs,
                           const int* dims, int n_dims, void* stream,
                           bool accumulate) {
  if (n_dims != WGRAD_DIMS || n_ptrs != WGRAD_PTRS)
    return (int)cudaErrorInvalidValue;
  WArgs a = {};
  a.M = dims[0]; a.SC = dims[1]; a.DC = dims[2]; a.WT = dims[3];
  const int n_tiles = dims[4], splits = dims[5];
  a.m_per = dims[6];
  const int kernel = dims[7];
  if (a.M < 1 || n_tiles < 1 || splits < 1 || splits > 65535 || a.m_per < 1 ||
      (long long)a.m_per * splits < a.M || a.SC % 16 || a.DC % 16 ||
      kernel < WGRAD_FP32 || kernel > WGRAD_WGMMA)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  a.stash = ptrs[0]; a.dzbuf = ptrs[1];
  a.tiles = (const Tile*)ptrs[2];
  a.part = (float*)ptrs[3];
  float* wout = (float*)ptrs[4];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (kernel == WGRAD_WGMMA) {
    if (a.m_per % WW_PTS || ((uintptr_t)a.stash & 15) ||
        ((uintptr_t)a.dzbuf & 15) || n_tiles % 2 ||
        (long long)n_tiles * splits > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    rc = wgrad_wgmma_launch(a, n_tiles, splits, st);
    if (rc == 0) rc = (int)cudaGetLastError();
  } else {
    const dim3 grid(n_tiles, splits);
    if (kernel == WGRAD_MMA) {
      const int smem = 4 * WG_PT * WG_LD * (int)sizeof(__nv_bfloat16);
      cudaFuncSetAttribute(wgrad_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      wgrad_bf16_kernel<<<grid, NTHREADS, smem, st>>>(a);
    } else {
      wgrad_f32_kernel<<<grid, NTHREADS, 0, st>>>(a);
    }
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  return reduce_partials(a.part, splits, a.WT, accumulate, wout, st);
}

}  // namespace
