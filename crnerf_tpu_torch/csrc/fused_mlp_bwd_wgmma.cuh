// The dz chain of the per-point MLP's backward on Hopper: the same function
// as mlp_bwd_chain_kernel (fused_mlp_bwd.cu, bf16), the per-point heads'
// backward and the dz chain from the slab's stash, with its products on
// wgmma, its weights streamed by TMA and its stash and dz rows moved by TMA
// tensor maps.
//
// Replaces the chain half of crnerf_tpu/ops/fused_mlp.py:_make_bwd_kernel
// (the Pallas TPU kernel behind make_fused_mlp_train's VJP) for the bf16
// shape that mlp_bwd_variant (ops/fused_mlp.py) gives to this kernel: the
// served MLPs' widths WP = 256, HP = 128, CP = 64 and at most MC_MAX_L
// trunk layers. One instance is built, included by fused_mlp_bwd.cu, whose
// wgmma slabs run it between the wgmma stash forward
// (fused_mlp_fwd_wgmma.cuh, STASH) and K2's weight gradient. Its outputs
// are the mma.sync chain's: the dz rows [dz_0 .. dz_{L-1} | dhf | dz_sigma
// (32, column 0) | ddd | dz_feat] at bf16 and one partial row of (DC + WP)
// sums a CTA (the bias sums, then the sigma weight gradient), so
// reduce_partials and the weight gradient run on them unchanged.
//
// What bounds it: per point ~1.1 MFLOP of products (dz @ W^T through the
// feature head, the dir layer, the final layer and the trunk) against
// ~4.4 KB of stash read and ~5 KB of dz written: device memory. The
// mma.sync chain ran at ~83 TFLOP/s, each warp reading its transposed
// weight fragments from L2 for 64 rows. Design, the fused render's wgmma
// chain's (fused_render_bwd_wgmma.cuh) with K4's head and no rays, on the
// pieces the two share (wgmma_tile.cuh):
//   * A persistent grid, one CTA an SM, static schedule: an item is a tile
//     of 128 consecutive points, warpgroup g its rows 64 g .. 64 g + 63.
//     Rows past the slab's end load as zeros (the tensor map), have zero
//     cotangents, add exact zeros to every sum and are not stored.
//     Warpgroup 2 is the producer: one lane streams the item's weight
//     program, the chain's stream (wgmma_chain_weights, its sigma columns
//     skipped: the sigma head runs in fp32 on the unrounded row), into a
//     two-slot ring.
//   * Per tile: TMA loads h_{L-1} and dd of the warpgroup's 64 rows from
//     the stash; z_sigma in fp32 (wg_sigma_rows, the forward's order) gives
//     dz_sigma = g_sigma * sigmoid(z_sigma), whose bias sum and weight
//     gradient h_{L-1}^T dz_sigma are summed here in fp32, one thread a
//     column, rows in order; the feature head's product on dd gives
//     dz_feat = g_feat * f * (1 - f).
//   * Then each product dz @ W^T with dz the A operand in the warpgroup's
//     buffer: ddd (masked by dd in place), dhf = ddd @ W_dh^T, the trunk
//     (wg_chain_trunk; dz_sigma * w_sigma added unrounded in fp32 in the
//     final layer's epilogue, before its mask). Every epilogue applies its
//     ReLU mask, rounds to bf16, writes dz back as the next A and adds the
//     unrounded fp32 values into the column sums (wg_dz_epilogue); one lane
//     stores each dz by TMA into the dz rows while the next product runs,
//     and loads the next layer's stash tile during that product. ddd is
//     per point: its rows are the A of the weight gradient's dir-encode job
//     (the stash's dir-encode columns), so there is no per-ray sum.
//   * Fixed order everywhere, no atomics: per column the warp's 16 rows by
//     shuffles, the four warps' sums in warp order, each warpgroup's
//     running sums apart, summed per CTA at the end, the CTAs in index
//     order by reduce_partials, the slabs in slab order. Two runs give the
//     same bits; the order differs from the mma.sync chain's, so the two
//     agree to GRAD_TOL.
//   * Group shapes are template parameters and no wait or branch falls
//     inside a product group (note C7520).
//   * Dtype policy as the mma.sync chain's: every product operand (dz,
//     activations) at bf16 with fp32 accumulation; the sigma branch wholly
//     fp32; the bias sums from the unrounded dz.

#pragma once

#include "wgrad_wgmma.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int MC_MAX_L = 8;    // trunk layers: the sums' shared memory
constexpr int MC_NS = 2;       // weight slots

struct MWArgs {
  const float* gfeat;   // (M, C) cotangent of the features
  const float* gsig;    // (M) cotangent of sigma
  __nv_bfloat16* dzbuf; // (M, DC)
  float* bpart;         // (grid, DC + WP) per-CTA partial sums
  const float* wsrow;   // (WP) sigma weights, fp32, unrounded
  const float* bs;      // sigma head bias (column 0)
  const float* bc;      // feature head bias (CP)
  int M, L, C, DC;
};

// 1024 to align, the barriers, the ring, both warpgroups' dz buffers and
// stash tiles (WP columns each), the warps' column sums (2 x 4 x WP) and
// dz_sigma (2 x 64) floats; the sums (2 x (DC + WP)) after
template <int WP>
__host__ __device__ constexpr int mc_fixed_bytes() {
  return 1024 + 1024 + MC_NS * WP * 128 + 4 * (WP / 64) * A_SLICE +
         (8 * WP + 2 * WG_ROWS) * 4;
}

// ------------------------------------------------------------- kernel
// smap: the slab's stash (M, SC), dmap: its dz rows (M, DC), both
// ray_rows_map over the M points.
template <int WP, int HP, int CP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mlp_bwd_chain_wgmma_kernel(const __grid_constant__ CUtensorMap smap,
                               const __grid_constant__ CUtensorMap dmap,
                               const MWArgs a,
                               const uint8_t* __restrict__ wpack) {
  constexpr int SLOT = WP * 128;
  constexpr int NS = MC_NS;
  constexpr int NB_W = (WP / 64) * A_SLICE;   // a warpgroup's WP columns
  static_assert(WP % 64 == 0 && HP % 64 == 0 && CP % 64 == 0 &&
                    WP <= 256 && HP / 64 + CP / 64 <= WP / 64,
                "widths");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WG_MAX_NS;
  uint64_t* mfull = empty + WG_MAX_NS;     // a stash load of warpgroup g
  uint8_t* ring = smem + 1024;
  uint8_t* abufs = ring + NS * SLOT;       // dz (and dd at first)
  uint8_t* mbufs = abufs + 2 * NB_W;       // stash tiles (masks, h_{L-1})
  float* red = reinterpret_cast<float*>(mbufs + 2 * NB_W);  // [wg][warp][WP]
  float* dzsb = red + 8 * WP;              // [warpgroup][64] dz_sigma
  float* bacc = dzsb + 2 * WG_ROWS;        // [warpgroup][DC + WP]

  const int tid = threadIdx.x;
  const int L = a.L, DC = a.DC, BT = a.DC + WP;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(&mfull[0], 1);
    mbar_init(&mfull[1], 1);
    fence_barrier_init();
  }
  for (int i = tid; i < 2 * BT; i += WG_THREADS) bacc[i] = 0.f;
  __syncthreads();

  const int items = (a.M + 2 * WG_ROWS - 1) / (2 * WG_ROWS);

  if (tid >= 256) {  // ----------------------------------------- producer
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (tid != 256) return;
    Ring rg;
    using O = ChainStream<WP, HP, CP>;
#pragma unroll 1
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      wg_put_run<NS, SLOT>(wpack, O::WC, HP / 64, CP * 128, ring, full,
                           empty, rg);
      wg_put_run<NS, SLOT>(wpack, O::WCT, CP / 64, HP * 128, ring, full,
                           empty, rg);
      wg_put_run<NS, SLOT>(wpack, O::WDHT, HP / 64, WP * 128, ring, full,
                           empty, rg);
      wg_put_run<NS, SLOT>(wpack, O::WFT, L * (WP / 64), WP * 128, ring,
                           full, empty, rg);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<WG_REGS_CONSUMER>();
  const int g = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const bool leader = wtid == 0;
  const int wg_bar = 2 + g;
  auto wg_sync = [&]() { named_bar_sync(wg_bar, 128); };
  auto both_sync = [&]() { named_bar_sync(1, 256); };

  uint8_t* abuf = abufs + g * NB_W;
  uint8_t* mbuf = mbufs + g * NB_W;
  const uint32_t abuf_a = smem_u32(abuf), ring_a = smem_u32(ring);
  float* rd = red + g * 4 * WP;
  float* dzs = dzsb + g * WG_ROWS;
  float* bac = bacc + g * BT;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  // stash columns: h_i at i WP, dd at (L + 1) WP; dz columns: dz_i at i WP,
  // then dhf, dz_sigma (32), ddd, dz_feat
  const int s_top = (L - 1) * WP, s_dd = (L + 1) * WP;
  const int d_hf = L * WP, d_sig = d_hf + WP, d_ddd = d_sig + 32,
            d_feat = d_ddd + HP;

  Ring rg;
  int mph = 0;
  float acc[WP / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int pb = item * 2 * WG_ROWS + g * WG_ROWS;   // row 0's point
    const int nrows = max(0, min(WG_ROWS, a.M - pb));
    const int lr = min(pb, a.M - 1);   // a box that starts inside the slab
    // nslices 64-column slices of buf into dz columns col.. of this
    // warpgroup's rows (clipped at M)
    auto store_dz = [&](const uint8_t* buf, int nslices, int col) {
      if (leader && nrows > 0) {
        for (int k = 0; k < nslices; ++k)
          tma_store_3d(&dmap, buf + k * A_SLICE, col + 64 * k, pb, 0);
        bulk_commit();
      }
    };

    // h_{L-1} into the stash tile and dd into the dz buffer
    wg_sync();
    if (leader) {
      bulk_wait_read();   // the dz stores have left the buffer
      mbar_expect_tx(&mfull[g], (WP / 64 + HP / 64) * A_SLICE);
      for (int k = 0; k < WP / 64; ++k)
        tma_load_3d(mbuf + k * A_SLICE, &smap, &mfull[g], s_top + 64 * k,
                    lr, 0);
      for (int k = 0; k < HP / 64; ++k)
        tma_load_3d(abuf + k * A_SLICE, &smap, &mfull[g], s_dd + 64 * k, lr,
                    0);
    }
    mbar_wait(&mfull[g], mph);
    mph ^= 1;

    // ---- the sigma branch, fp32: z_sigma, dz_sigma, its sums
    wg_sigma_rows<WP>(mbuf, a.wsrow, a.bs[0], dzs, warp, lane);
    wg_sync();
    if (wtid < WG_ROWS)
      dzs[wtid] = wtid < nrows ? a.gsig[pb + wtid] * sigmoidf(dzs[wtid])
                               : 0.f;
    wg_sync();
    if (wtid == 0) {
      float sb = 0.f;
      for (int r = 0; r < WG_ROWS; ++r) sb += dzs[r];
      bac[d_sig] += sb;
    }
    for (int k = wtid; k < WP; k += 128) {   // h_{L-1}^T dz_sigma
      float sw = 0.f;
      for (int r = 0; r < WG_ROWS; ++r)
        sw += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                  mbuf + sw_off(r, k))) *
              dzs[r];
      bac[DC + k] += sw;
    }
    for (int i = wtid; i < nrows * 4; i += 128) {   // the dz_sigma block
      const int r = i >> 2, q = i & 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q == 0)
        v.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(dzs[r]));
      *reinterpret_cast<uint4*>(a.dzbuf + (size_t)(pb + r) * DC + d_sig +
                                8 * q) = v;
    }

    // ---- dz_feat = g_feat * f * (1 - f), f = sigmoid(dd @ W_c + b_c),
    // into the A slice after dd
    {
      float fc[CP / 2];
      zero_acc(fc);
      wg_product<CP, NS, SLOT>(
          fc, HP / 64, [&](int kc) { return abuf_a + kc * A_SLICE; }, ring_a,
          full, empty, rg, leader);
      const int pa = pb + r0, pc = pb + r0 + 8;
      const bool oka = r0 < nrows, okc = r0 + 8 < nrows;
      float* rdw = rd + warp * CP;
#pragma unroll
      for (int nb = 0; nb < CP / 8; ++nb) {
        const int c = nb * 8 + cq;
        const float b0 = a.bc[c], b1 = a.bc[c + 1];
        const float f0 = sigmoidf(fc[nb * 4] + b0);
        const float f1 = sigmoidf(fc[nb * 4 + 1] + b1);
        const float f2 = sigmoidf(fc[nb * 4 + 2] + b0);
        const float f3 = sigmoidf(fc[nb * 4 + 3] + b1);
        const bool c0 = c < a.C, c1 = c + 1 < a.C;
        const float g0 = oka && c0 ? a.gfeat[(size_t)pa * a.C + c] : 0.f;
        const float g1 = oka && c1 ? a.gfeat[(size_t)pa * a.C + c + 1] : 0.f;
        const float g2 = okc && c0 ? a.gfeat[(size_t)pc * a.C + c] : 0.f;
        const float g3 = okc && c1 ? a.gfeat[(size_t)pc * a.C + c + 1] : 0.f;
        const float v0 = g0 * f0 * (1.f - f0), v1 = g1 * f1 * (1.f - f1);
        const float v2 = g2 * f2 * (1.f - f2), v3 = g3 * f3 * (1.f - f3);
        st_bf16x2(abuf, r0, HP + c, v0, v1);
        st_bf16x2(abuf, r0 + 8, HP + c, v2, v3);
        warp_colsum(v0 + v2, v1 + v3, rdw, c, lane);
      }
    }
    fence_proxy_async();
    wg_sync();
    add_colsums(rd, CP, bac + d_feat, wtid);
    store_dz(abuf + (HP / 64) * A_SLICE, CP / 64, d_feat);

    // ---- ddd = (dd > 0) * dz_feat @ W_c^T, over dd in place: per point
    {
      float acc_d[HP / 2];
      zero_acc(acc_d);
      wg_product<HP, NS, SLOT>(
          acc_d, CP / 64,
          [&](int kc) { return abuf_a + (HP / 64 + kc) * A_SLICE; }, ring_a,
          full, empty, rg, leader);
      wg_sync();
      wg_dz_epilogue<HP>(acc_d, abuf, abuf, nullptr, 0.f, 0.f,
                         rd + warp * HP, r0, cq, lane);
    }
    fence_proxy_async();
    wg_sync();
    add_colsums(rd, HP, bac + d_ddd, wtid);
    store_dz(abuf, HP / 64, d_ddd);

    // ---- dhf = ddd @ W_dh^T
    zero_acc(acc);
    wg_product<WP, NS, SLOT>(
        acc, HP / 64, [&](int kc) { return abuf_a + kc * A_SLICE; }, ring_a,
        full, empty, rg, leader);
    if (leader) bulk_wait_read();
    wg_sync();
    wg_dz_epilogue<WP>(acc, abuf, nullptr, nullptr, 0.f, 0.f, rd + warp * WP,
                       r0, cq, lane);
    fence_proxy_async();
    wg_sync();
    add_colsums(rd, WP, bac + d_hf, wtid);
    store_dz(abuf, WP / 64, d_hf);

    // ---- dz_{L-1} .. dz_0 down the trunk, the sigma branch in fp32:
    // dz_sigma unrounded and the unrounded sigma weights
    wg_chain_trunk<WP, NS, SLOT>(
        L, acc, abuf, abuf_a, mbuf, ring_a, full, empty, rg, leader, warp,
        lane, wtid, r0, cq, rd, bac, a.wsrow, dzs[r0], dzs[r0 + 8], wg_sync,
        [&]() {
          mbar_wait(&mfull[g], mph);
          mph ^= 1;
        },
        [&](int i) {
          mbar_expect_tx(&mfull[g], (WP / 64) * A_SLICE);
          for (int k = 0; k < WP / 64; ++k)
            tma_load_3d(mbuf + k * A_SLICE, &smap, &mfull[g],
                        i * WP + 64 * k, lr, 0);
        },
        [&](int i) { store_dz(abuf, WP / 64, i * WP); });
  }
  if (leader) bulk_wait();
  both_sync();
  float* bp = a.bpart + (size_t)blockIdx.x * BT;
  for (int c = tid; c < BT; c += 256) bp[c] = bacc[c] + bacc[BT + c];
}

// Launches mlp_bwd_chain_wgmma_kernel<256, 128, 64> on ``grid`` CTAs over
// the slab's M points, then the fixed-order sum of their partial rows into
// bout (DC + WP), onto what it holds with ``accumulate``. stash (M, SC)
// and dzbuf (M, DC) at bf16, their rows 16-byte aligned; ``wpack`` the
// chain's weight stream. Returns cudaGetLastError(), a CUresult of a
// tensor map, or cudaErrorInvalidValue.
int mlp_bwd_chain_wgmma_launch(const MWArgs& a, const void* stash, int SC,
                               const void* wpack, int grid, float* bout,
                               bool accumulate, cudaStream_t st) {
  constexpr int WP = 256;
  static_assert(mc_fixed_bytes<WP>() +
                        2 * ((MC_MAX_L + 2) * WP + 32 + 128 + 64) * 4 <=
                    WG_SMEM_MAX,
                "shared memory");
  if (a.M < 1 || a.L < 1 || a.L > MC_MAX_L || a.C < 1 || a.C > 64 ||
      grid < 1 || a.DC != (a.L + 1) * WP + 32 + 128 + 64 || SC % 8 ||
      SC < (a.L + 1) * WP + 128 || !wpack ||
      (((uintptr_t)stash | (uintptr_t)a.dzbuf | (uintptr_t)wpack) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, dmap;
  int rc = ray_rows_map(&smap, stash, 1, a.M, SC);
  if (!rc) rc = ray_rows_map(&dmap, a.dzbuf, 1, a.M, a.DC);
  if (rc) return rc;
  const int smem = mc_fixed_bytes<WP>() + 2 * (a.DC + WP) * 4;
  auto kern = mlp_bwd_chain_wgmma_kernel<WP, 128, 64>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, WG_THREADS, smem, st>>>(smap, dmap, a,
                                       static_cast<const uint8_t*>(wpack));
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return reduce_partials(a.bpart, grid, a.DC + WP, accumulate, bout, st);
}

}  // namespace
