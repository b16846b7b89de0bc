// The first kernel of the stash backward on Hopper: the same function as
// render_bwd_chain_kernel (fused_render_bwd.cuh, bf16), the compositing
// backward and the dz chain from the forward's stash, with its products on
// wgmma, its weights streamed by TMA and its stash and dz rows moved by
// TMA tensor maps.
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_bwd_stash_kernel
// (the Pallas TPU kernel; its dz-chain half) for the bf16 shape that
// chain_variant (ops/fused_render.py) gives to this kernel: the served
// MLPs' widths WP = 256, HP = 128, CP = 64, at most CW_MAX_L trunk layers
// and CW_MAX_S samples a ray. One instance is built. Included by
// fused_render_bwd.cu (the stash route) and fused_render_bwd_recompute.cu
// (the recompute backward's slabs at the same shapes); fp32 and other
// shapes stay on the mma.sync chain. Its outputs
// are the mma.sync chain's: the dz rows [dz_0 .. dz_{L-1} | dhf | dz_sigma
// (32, column 0) | ddd | dz_feat] at bf16, one partial row of bias sums a
// CTA, and each ray's summed ddd, so reduce_partials, dir_wgrad_kernel and
// the weight-gradient kernel run on them unchanged.
//
// What bounds it: per point ~1.1 MFLOP of products (dz @ W^T through the
// feature head, the dir layer, the final layer and the trunk) against
// ~4.3 KB of stash read and ~5 KB of dz written: device memory (5.9 ms at
// 16,384 x 128 on an H100 SXM against 2.4 ms of products at peak). The
// mma.sync chain ran at ~72 TFLOP/s, each warp reading its transposed
// weight fragments from L2 for 32 rows. Design, as the wgmma forward's
// (fused_render_fwd_wgmma.cuh, wgmma_tile.cuh):
//   * A persistent grid, one CTA an SM, static schedule (item +=
//     gridDim.x): an item is one ray (S > 64), as tiles of 128 samples, or
//     two rays (S <= 64), one a warpgroup. Warpgroup 2 is the producer: one
//     lane streams the item's weight program (the transposed weights
//     gathered on the host, wgmma_chain_weights) into a two-slot ring.
//   * Phase 1, per tile: TMA loads h_{L-1} and dd of the warpgroup's 64
//     rows from the stash; the sigma head (a 64 x 8 product) and the
//     feature head give z_sigma and g_fmap . feat per row.
//   * The compositing forward and backward of each ray: one warp, eight
//     samples a lane, the transmittance as a product scan and the suffix
//     sums of weights * dweights as a sum scan over the lanes (the
//     mma.sync chain runs both scans in one thread).
//   * Phase 2, per tile: dz_feat from the feature head's registers (kept
//     from phase 1 when the item is one tile), then each product dz @ W^T
//     with dz the A operand in the warpgroup's buffer; every epilogue
//     applies the ReLU mask (dd in place, h_i from the stash tile), rounds
//     to bf16, writes dz back as the next A, and adds the unrounded fp32
//     values into the column sums. One lane stores each dz by TMA into the
//     dz rows while the next product runs, and loads the next layer's
//     stash tile (64 x 256 bf16 a warpgroup) during that product, after
//     this layer's epilogue has read its own. Shared memory: ring 64 KB,
//     dz buffers 64 KB, stash tiles 64 KB, bias sums 2 x DC floats.
//   * Fixed order everywhere, no atomics: per column the warp's 16 rows
//     by shuffles, the four warps' sums in warp order, each warpgroup's
//     running sums apart, summed per CTA at the end, the CTAs in index
//     order by reduce_partials. Two runs give the same bits. The order
//     differs from the mma.sync chain's, so the two agree to GRAD_TOL.
//   * A product group is one slice's four k16 steps; group shapes are
//     template parameters and no wait or branch falls inside a group (a
//     wait there makes ptxas serialise every wgmma, note C7520).
//   * Dtype policy as the mma.sync chain's: every product operand (dz,
//     activations) at bf16, fp32 accumulation; compositing, g_fmap . feat
//     and the bias sums fp32 on the unrounded values.

#pragma once

#include "wgrad_wgmma.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int CW_MAX_S = 256;   // samples a ray: eight a lane of one warp
constexpr int CW_MAX_L = 8;     // trunk layers: the bias sums' shared memory
constexpr int CW_NS = 2;        // weight slots

struct CArgs {
  const float* z;       // (N, S)
  const float* noise;   // (N, S)
  const float* gray;    // (N, ldo) cotangent of [fmap | depth | 0]
  const float* gw;      // (N, S) cotangent of the weights
  __nv_bfloat16* dzbuf; // (N*S, DC)
  float* bpart;         // (grid, DC) per-CTA bias partials
  float* ddray;         // (N, HP) each ray's summed ddd, bf16-rounded
  const float* bs;      // sigma head bias (column 0)
  const float* bc;      // feature head bias (CP)
  const float* wsv;     // (WP) sigma weights at bf16, held as f32
  int N, S, L, C, ldo, DC;
};

// floats but the bias sums: the warps' column sums (2 x 4 x WP), the ray's
// ddd sums (2 x HP), g_fmap (2 x CP), the ray arrays (2 x CW_MAX_S)
template <int WP, int HP, int CP>
__host__ __device__ constexpr int cw_floats() {
  return 8 * WP + 2 * HP + 2 * CP + 2 * CW_MAX_S;
}

// 1024 to align, the barriers, the ring, both warpgroups' dz buffers and
// stash tiles (WP columns each), the floats; the bias sums (2 x DC) after
template <int WP, int HP, int CP>
__host__ __device__ constexpr int cw_fixed_bytes() {
  return 1024 + 1024 + CW_NS * WP * 128 + 4 * (WP / 64) * A_SLICE +
         cw_floats<WP, HP, CP>() * 4;
}

// The compositing forward and backward of one ray by one warp, samples
// 8 lane .. 8 lane + 7: pa holds z_sigma and pb g_fmap . feat of samples
// j < S; after it pa holds dz_sigma and pb the weights of samples j <
// n_rows, 0 past S (and everywhere when !ok). Returns the sum of dz_sigma
// on every lane.
__device__ __forceinline__ float composite_bwd(
    const float* zr, const float* nr, const float* gwr, float ddepth, int S,
    bool ok, int n_rows, float* pa, float* pb, int lane) {
  float al[8], ex[8], dl[8], pre[8], dw[8], zs[8];
  float lp = 1.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = 8 * lane + q;
    al[q] = 0.f; ex[q] = 1.f; dl[q] = 0.f; pre[q] = 0.f; dw[q] = 0.f;
    zs[q] = 0.f;
    if (ok && j < S) {
      const float zj = zr[j];
      zs[q] = pa[j];
      dl[q] = j < S - 1 ? zr[j + 1] - zj : DELTA_INF;
      pre[q] = softplusf(zs[q]) + nr[j];
      ex[q] = expf(-dl[q] * fmaxf(pre[q], 0.f));
      al[q] = 1.f - ex[q];
      dw[q] = gwr[j] + ddepth * zj + pb[j];
    }
    lp *= 1.f - al[q];
  }
  // transmittance entering the lane's first sample: a product scan
  float incl = lp;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= y;
  }
  float t = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) t = 1.f;
  float tr[8], wt[8], ls = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    tr[q] = t;
    wt[q] = al[q] * t;
    t *= 1.f - al[q];
    ls += wt[q] * dw[q];
  }
  // sum over the samples after the lane's last of weights * dweights
  float incs = ls;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, incs, off);
    if (lane + off < 32) incs += y;
  }
  float suf = __shfl_down_sync(0xffffffffu, incs, 1);
  if (lane == 31) suf = 0.f;
  float dzs[8];
#pragma unroll
  for (int q = 7; q >= 0; --q) {
    const float one_m = fmaxf(1.f - al[q], 1e-30f);
    const float dalpha = tr[q] * dw[q] - suf / one_m;
    suf += wt[q] * dw[q];
    const float dact = dalpha * dl[q] * ex[q];
    dzs[q] = pre[q] > 0.f ? dact * sigmoidf(zs[q]) : 0.f;
  }
  float sb = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = 8 * lane + q;
    sb += dzs[q];
    if (j < n_rows) {
      pa[j] = dzs[q];
      pb[j] = wt[q];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  return sb;
}

// ------------------------------------------------------------- kernel
// smap: the stash (N, S, SC), dmap: the dz rows (N, S, DC), both
// ray_rows_map. pair: S <= 64, two rays an item (warpgroup g takes ray
// 2 item + g); else one ray an item, tiles of 128 samples (warpgroup g
// takes samples 128 t + 64 g ..).
template <int WP, int HP, int CP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    render_bwd_chain_wgmma_kernel(const __grid_constant__ CUtensorMap smap,
                                  const __grid_constant__ CUtensorMap dmap,
                                  const CArgs a,
                                  const uint8_t* __restrict__ wpack,
                                  const int pair) {
  constexpr int SLOT = WP * 128;
  constexpr int NS = CW_NS;
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
  uint8_t* abufs = ring + NS * SLOT;       // dz (and dd in phase 1)
  uint8_t* mbufs = abufs + 2 * NB_W;       // stash tiles (masks, h_{L-1})
  float* fl = reinterpret_cast<float*>(mbufs + 2 * NB_W);
  float* red = fl;                          // [warpgroup][warp][WP]
  float* ddacc = red + 8 * WP;              // [warpgroup][HP]
  float* gfm = ddacc + 2 * HP;              // [warpgroup][CP]
  float* pa = gfm + 2 * CP;                 // [CW_MAX_S] z_sigma, dz_sigma
  float* pb = pa + CW_MAX_S;                // [CW_MAX_S] g_fmap.feat, weights
  float* bacc = pb + CW_MAX_S;              // [warpgroup][DC]

  const int tid = threadIdx.x;
  const int S = a.S, L = a.L, DC = a.DC;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(&mfull[0], 1);
    mbar_init(&mfull[1], 1);
    fence_barrier_init();
  }
  for (int i = tid; i < 2 * DC; i += WG_THREADS) bacc[i] = 0.f;
  __syncthreads();

  const int items = pair ? (a.N + 1) / 2 : a.N;
  const int tiles = pair ? 1 : (S + 127) / 128;

  if (tid >= 256) {  // ----------------------------------------- producer
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (tid != 256) return;
    Ring rg;
    using O = ChainStream<WP, HP, CP>;
    auto put_run = [&](uint32_t off, int n, uint32_t bytes) {
      wg_put_run<NS, SLOT>(wpack, off, n, bytes, ring, full, empty, rg);
    };
#pragma unroll 1
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
#pragma unroll 1
      for (int t = 0; t < tiles; ++t) {
        put_run(0, WP / 64, SIG_N * 128);
        put_run(O::WC, HP / 64, CP * 128);
      }
#pragma unroll 1
      for (int t = 0; t < tiles; ++t) {
        if (tiles > 1) put_run(O::WC, HP / 64, CP * 128);
        put_run(O::WCT, CP / 64, HP * 128);
        put_run(O::WDHT, HP / 64, WP * 128);
        put_run(O::WFT, L * (WP / 64), WP * 128);
      }
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
  const uint32_t abuf_a = smem_u32(abuf), mbuf_a = smem_u32(mbuf);
  const uint32_t ring_a = smem_u32(ring);
  float* rd = red + g * 4 * WP;
  float* dda = ddacc + g * HP;
  float* gf = gfm + g * CP;
  float* bac = bacc + g * DC;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  // stash columns: h_i at i WP, dd at (L + 1) WP; dz columns: dz_i at i WP,
  // then dhf, dz_sigma (32), ddd, dz_feat
  const int s_top = (L - 1) * WP, s_dd = (L + 1) * WP;
  const int d_hf = L * WP, d_sig = d_hf + WP, d_ddd = d_sig + 32,
            d_feat = d_ddd + HP;

  Ring rg;
  int mph = 0;
  float acc[WP / 2];
  float fc[CP / 2];   // sigmoid(dd @ W_c + b_c) of the tile's rows
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int ray_raw = pair ? 2 * item + g : item;
    const bool ray_ok = ray_raw < a.N;
    const int ray = ray_ok ? ray_raw : a.N - 1;
    const int base = pair ? g * WG_ROWS : 0;   // the ray's samples in pa, pb
    for (int c = wtid; c < CP; c += 128)
      gf[c] = (ray_ok && c < a.C) ? a.gray[(size_t)ray * a.ldo + c] : 0.f;
    for (int c = wtid; c < HP; c += 128) dda[c] = 0.f;

    // h_{L-1} into the stash tile and dd into the dz buffer, rows from sb
    auto load_top = [&](int sb) {
      wg_sync();
      if (leader) {
        bulk_wait_read();   // the dz stores have left the buffer
        mbar_expect_tx(&mfull[g], (WP / 64 + HP / 64) * A_SLICE);
        for (int k = 0; k < WP / 64; ++k)
          tma_load_3d(mbuf + k * A_SLICE, &smap, &mfull[g], s_top + 64 * k,
                      sb, ray);
        for (int k = 0; k < HP / 64; ++k)
          tma_load_3d(abuf + k * A_SLICE, &smap, &mfull[g], s_dd + 64 * k,
                      sb, ray);
      }
      mbar_wait(&mfull[g], mph);
      mph ^= 1;
    };
    // the feature head on dd: fc = sigmoid(dd @ W_c + b_c)
    auto feature_head = [&]() {
      zero_acc(fc);
      wg_product<CP, NS, SLOT>(
          fc, HP / 64, [&](int kc) { return abuf_a + kc * A_SLICE; }, ring_a,
          full, empty, rg, leader);
#pragma unroll
      for (int nb = 0; nb < CP / 8; ++nb) {
        const int c = nb * 8 + cq;
        const float b0 = a.bc[c], b1 = a.bc[c + 1];
        fc[nb * 4] = sigmoidf(fc[nb * 4] + b0);
        fc[nb * 4 + 1] = sigmoidf(fc[nb * 4 + 1] + b1);
        fc[nb * 4 + 2] = sigmoidf(fc[nb * 4 + 2] + b0);
        fc[nb * 4 + 3] = sigmoidf(fc[nb * 4 + 3] + b1);
      }
    };

    // ---- phase 1: z_sigma and g_fmap . feat of every sample of the item
    for (int t = 0; t < tiles; ++t) {
      const int sb = pair ? 0 : t * 128 + g * WG_ROWS;
      const int pj = base + sb;
      load_top(sb);
      {
        float acc_s[SIG_N / 2];
        zero_acc(acc_s);
        wg_product<SIG_N, NS, SLOT>(
            acc_s, WP / 64, [&](int kc) { return mbuf_a + kc * A_SLICE; },
            ring_a, full, empty, rg, leader);
        if ((lane & 3) == 0) {
          pa[pj + r0] = acc_s[0] + a.bs[0];
          pa[pj + r0 + 8] = acc_s[2] + a.bs[0];
        }
      }
      feature_head();
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < CP / 8; ++nb) {
        const int c = nb * 8 + cq;
        p0 += gf[c] * fc[nb * 4] + gf[c + 1] * fc[nb * 4 + 1];
        p1 += gf[c] * fc[nb * 4 + 2] + gf[c + 1] * fc[nb * 4 + 3];
      }
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      if ((lane & 3) == 0) {
        pb[pj + r0] = p0;
        pb[pj + r0 + 8] = p1;
      }
    }

    // ---- the compositing forward and backward of the item's ray(s)
    both_sync();
    if (warp == 0 && (pair || g == 0)) {
      const float* gr = a.gray + (size_t)ray * a.ldo;
      const float sb = composite_bwd(
          a.z + (size_t)ray * S, a.noise + (size_t)ray * S,
          a.gw + (size_t)ray * S, ray_ok ? gr[a.C] : 0.f, S, ray_ok,
          pair ? WG_ROWS : tiles * 128, pa + base, pb + base, lane);
      if (lane == 0) bac[d_sig] += sb;
    }
    both_sync();

    // ---- phase 2: the dz chain, tile by tile
    for (int t = 0; t < tiles; ++t) {
      const int sb = pair ? 0 : t * 128 + g * WG_ROWS;
      const int pj = base + sb;
      // nslices 64-column slices of buf into dz columns col.. of this
      // warpgroup's rows (clipped at S; none for a missing ray)
      auto store_dz = [&](const uint8_t* buf, int nslices, int col) {
        if (leader && ray_ok && sb < S) {
          for (int k = 0; k < nslices; ++k)
            tma_store_3d(&dmap, buf + k * A_SLICE, col + 64 * k, sb, ray);
          bulk_commit();
        }
      };
      if (tiles > 1) {
        load_top(sb);
        feature_head();
      }
      // dz_feat = weights * g_fmap * feat * (1 - feat), the A slice after
      // dd; the dz_sigma block of the rows (column 0)
      {
        const float wa = pb[pj + r0], wb = pb[pj + r0 + 8];
        float* rdw = rd + warp * CP;
#pragma unroll
        for (int nb = 0; nb < CP / 8; ++nb) {
          const int c = nb * 8 + cq;
          const float g0 = gf[c], g1 = gf[c + 1];
          const float f0 = fc[nb * 4], f1 = fc[nb * 4 + 1],
                      f2 = fc[nb * 4 + 2], f3 = fc[nb * 4 + 3];
          const float v0 = wa * g0 * f0 * (1.f - f0);
          const float v1 = wa * g1 * f1 * (1.f - f1);
          const float v2 = wb * g0 * f2 * (1.f - f2);
          const float v3 = wb * g1 * f3 * (1.f - f3);
          st_bf16x2(abuf, r0, HP + c, v0, v1);
          st_bf16x2(abuf, r0 + 8, HP + c, v2, v3);
          warp_colsum(v0 + v2, v1 + v3, rdw, c, lane);
        }
        if (ray_ok) {
          for (int i = wtid; i < WG_ROWS * 4; i += 128) {
            const int r = i >> 2, q = i & 3;
            if (sb + r < S) {
              uint4 v = make_uint4(0u, 0u, 0u, 0u);
              if (q == 0)
                v.x = (uint32_t)__bfloat16_as_ushort(
                    __float2bfloat16_rn(pa[pj + r]));
              *reinterpret_cast<uint4*>(
                  a.dzbuf + ((size_t)ray * S + sb + r) * DC + d_sig +
                  8 * q) = v;
            }
          }
        }
      }
      // fc is spent: constant from here on, so that it holds no registers
      // through the products below (the next tile recomputes it)
      zero_acc(fc);
      fence_proxy_async();
      wg_sync();
      add_colsums(rd, CP, bac + d_feat, wtid);
      store_dz(abuf + (HP / 64) * A_SLICE, CP / 64, d_feat);

      // ddd = (dd > 0) * dz_feat @ W_c^T, over dd in place
      {
        float acc_d[HP / 2];
        zero_acc(acc_d);
        wg_product<HP, NS, SLOT>(
            acc_d, CP / 64,
            [&](int kc) { return abuf_a + (HP / 64 + kc) * A_SLICE; },
            ring_a, full, empty, rg, leader);
        wg_sync();
        wg_dz_epilogue<HP>(acc_d, abuf, abuf, nullptr, 0.f, 0.f,
                           rd + warp * HP, r0, cq, lane);
      }
      fence_proxy_async();
      wg_sync();
      add_colsums(rd, HP, dda, wtid);
      store_dz(abuf, HP / 64, d_ddd);

      // dhf = ddd @ W_dh^T
      zero_acc(acc);
      wg_product<WP, NS, SLOT>(
          acc, HP / 64, [&](int kc) { return abuf_a + kc * A_SLICE; }, ring_a,
          full, empty, rg, leader);
      if (leader) bulk_wait_read();
      wg_sync();
      wg_dz_epilogue<WP>(acc, abuf, nullptr, nullptr, 0.f, 0.f,
                         rd + warp * WP, r0, cq, lane);
      fence_proxy_async();
      wg_sync();
      add_colsums(rd, WP, bac + d_hf, wtid);
      store_dz(abuf, WP / 64, d_hf);

      // dz_{L-1} .. dz_0 down the trunk, the sigma branch at bf16: dz_sigma
      // rounded and the bf16 sigma weights
      wg_chain_trunk<WP, NS, SLOT>(
          L, acc, abuf, abuf_a, mbuf, ring_a, full, empty, rg, leader, warp,
          lane, wtid, r0, cq, rd, bac, a.wsv, bf16_round(pa[pj + r0]),
          bf16_round(pa[pj + r0 + 8]), wg_sync,
          [&]() {
            mbar_wait(&mfull[g], mph);
            mph ^= 1;
          },
          [&](int i) {
            mbar_expect_tx(&mfull[g], (WP / 64) * A_SLICE);
            for (int k = 0; k < WP / 64; ++k)
              tma_load_3d(mbuf + k * A_SLICE, &smap, &mfull[g],
                          i * WP + 64 * k, sb, ray);
          },
          [&](int i) { store_dz(abuf, WP / 64, i * WP); });
    }

    // ---- the ray's direction-layer sums: the bias, and the ray's summed
    // ddd rounded as the product operand it is in the dir-encode gradient
    both_sync();
    if (pair || g == 0) {
      for (int n = wtid; n < HP; n += 128) {
        const float tot = pair ? dda[n] : ddacc[n] + ddacc[HP + n];
        bac[d_ddd + n] += tot;
        if (ray_ok) a.ddray[(size_t)ray * HP + n] = bf16_round(tot);
      }
    }
    both_sync();
  }
  if (leader) bulk_wait();
  both_sync();
  float* bp = a.bpart + (size_t)blockIdx.x * DC;
  for (int c = tid; c < DC; c += 256) bp[c] = bacc[c] + bacc[DC + c];
}

// Launches render_bwd_chain_wgmma_kernel<WP, HP, CP> on ``grid`` CTAs;
// cudaGetLastError().
template <int WP, int HP, int CP>
int launch_chain_wgmma(const CUtensorMap& smap, const CUtensorMap& dmap,
                       const CArgs& a, const void* wpack, int grid,
                       cudaStream_t st) {
  static_assert(cw_fixed_bytes<WP, HP, CP>() +
                        2 * ((CW_MAX_L + 1) * WP + 32 + HP + CP) * 4 <=
                    WG_SMEM_MAX,
                "shared memory");
  const int smem = cw_fixed_bytes<WP, HP, CP>() + 2 * a.DC * 4;
  auto kern = render_bwd_chain_wgmma_kernel<WP, HP, CP>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<grid, WG_THREADS, smem, st>>>(smap, dmap, a,
                                       static_cast<const uint8_t*>(wpack),
                                       a.S <= WG_ROWS);
  return (int)cudaGetLastError();
}

constexpr int CW_PTRS = 15;

// ptrs (host array): z, noise, dirb, gray, gw, stash, dzbuf, bpart (grid x
// DC), ddray (N x HP), dpart (slices x DK*HP), bout (DC + DK*HP), bs, bc,
// wsv, then the weight stream (wgmma_chain_weights in ops/fused_render.py).
// dims as render_bwd_chain_entry takes them; only the shape this kernel
// takes: bf16, (WP, HP, CP) = (256, 128, 64), L <= CW_MAX_L, S <= CW_MAX_S,
// grid <= the items (rays, or pairs of rays when S <= 64). Launches the
// kernel, then the sums as render_bwd_chain_entry does (chain_sums; with
// ``accumulate`` onto what bout holds: the recompute backward's slabs).
// Returns cudaGetLastError(), a CUresult of a tensor map, or
// cudaErrorInvalidValue.
int render_bwd_chain_wgmma_entry(const void* const* ptrs, int n_ptrs,
                                 const int* dims, int n_dims, void* stream,
                                 bool accumulate) {
  if (n_dims != CHAIN_DIMS || n_ptrs != CW_PTRS)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  CArgs a = {};
  a.N = dims[0]; a.S = dims[1]; a.L = dims[2];
  const int WP = dims[3], HP = dims[4], CP = dims[5];
  a.C = dims[6];
  const int DK = dims[7];
  a.ldo = dims[8];
  const int SC = dims[9];
  a.DC = dims[10];
  const int slices = dims[11];
  const bool bf16 = dims[12] != 0;
  const int grid = dims[13];
  const int items = a.S <= WG_ROWS ? (a.N + 1) / 2 : a.N;
  if (!bf16 || WP != 256 || HP != 128 || CP != 64 || a.N < 1 || a.S < 1 ||
      a.S > CW_MAX_S || a.L < 1 || a.L > CW_MAX_L || a.C > CP ||
      a.C >= a.ldo || grid < 1 || grid > items || slices < 1 ||
      slices > 65535 || SC < (a.L + 1) * WP + HP || SC % 8 ||
      a.DC != (a.L + 1) * WP + 32 + HP + CP)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)ptrs[5] | (uintptr_t)ptrs[6] | (uintptr_t)ptrs[14]) & 15)
    return (int)cudaErrorInvalidValue;
  a.z = (const float*)ptrs[0]; a.noise = (const float*)ptrs[1];
  const float* dirb = (const float*)ptrs[2];
  a.gray = (const float*)ptrs[3]; a.gw = (const float*)ptrs[4];
  a.dzbuf = (__nv_bfloat16*)const_cast<void*>(ptrs[6]);
  a.bpart = (float*)ptrs[7];
  a.ddray = (float*)ptrs[8];
  float* dpart = (float*)ptrs[9];
  float* bout = (float*)ptrs[10];
  a.bs = (const float*)ptrs[11]; a.bc = (const float*)ptrs[12];
  a.wsv = (const float*)ptrs[13];
  CUtensorMap smap, dmap;
  int rc = ray_rows_map(&smap, ptrs[5], a.N, a.S, SC);
  if (!rc) rc = ray_rows_map(&dmap, a.dzbuf, a.N, a.S, a.DC);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = launch_chain_wgmma<256, 128, 64>(smap, dmap, a, ptrs[14], grid, st);
  if (rc != 0) return rc;
  return chain_sums(a.bpart, grid, a.DC, dirb, a.ddray, a.N, DK, HP, slices,
                    dpart, bout, accumulate, st);
}

}  // namespace
