// The pipelined fused render forward (S2) on Hopper: K1's rays-in,
// no-stash forward on the wgmma K1's machinery, with its two consumer
// warpgroups in ping-pong, so that one warpgroup's SIMT work (each layer's
// epilogue, the encode, the dir term, sigma, the compositing and the
// feature sums) runs while the other's products hold the tensor cores.
//
// Replaces the Pallas TPU kernel of scripts/spike_interleave.py:47
// (_make_pipe_fwd_kernel, reached from pipe_render_apply, pallas_call at
// :157) for the shape the wgmma K1 takes (ops/pipe_render.py
// pipe_variant: bf16, WP = 256, HP = 128, CP = 64, KE <= 128); other
// widths stay on the mma.sync S2 (pipe_render_fwd.cu). The TPU kernel
// holds P half-tiles of rays a grid step so that one half's encode can
// overlap another's matrix work. It computes exactly K1's function.
//
// What bounds it: as K1, the tensor cores (~1.2 MFLOP of products a
// sample point at 8x256). What holds the wgmma K1 at 43-49% of that: its
// two warpgroups share a tile and run their products and their epilogues
// at the same time, so the tensor cores idle through every epilogue.
// Design:
//   * K1's CTA: one persistent CTA an SM over items of P rays (``phases``),
//     a producer warpgroup streaming pre-swizzled weight slices by TMA
//     into an mbarrier ring (wgmma_weights' stream), two consumer
//     warpgroups of 64 rows (setmaxnreg 40 / 232), every piece of a tile's
//     work the code K1 runs (fused_render_fwd_wgmma.cuh, wgmma_tile.cuh).
//   * The warpgroups take turns at the tensor cores, one product phase
//     (a trunk layer, sigma, the final layer, the dir layer, the feature
//     head) at a time: warpgroup g waits at named barrier PP_TURN + g
//     before its products and arrives at the other's once its last product
//     group is issued (so the other's products queue behind it with no
//     gap), then waits for its own to retire and runs its epilogue while
//     the other's products run.
//   * Each warpgroup walks its own 64-sample tiles. With P >= 2 it takes
//     rays g, g + 2, .. of the item and carries their transmittance alone:
//     no warpgroup waits for the other's rows to composite. With P = 1
//     (one ray in flight: nothing to overlap but the two halves of one
//     ray) the warpgroups take the ray's even and odd tiles, as K1 does,
//     and hand each other the tiles' transmittance at two named barriers
//     of warp 0 (PP_TOT0, PP_TOT1). Every warpgroup runs as many tiles an
//     item; a missing ray's (or the odd half past S) is run on the last
//     ray and writes nothing, as K1's rows past S.
//   * The weight stream: the two consumers read the same program about a
//     phase apart, and a phase reads a whole layer (128 KB, 192 KB at a
//     skip), so a ring both release would have to hold a layer beside the
//     96 KB of activation buffers: it does not fit in 227 KB. The producer
//     streams the program once for each consumer instead, in the order the
//     turns take it (a slot released by the one warpgroup that read it):
//     twice K1's L2 reads of weights.
//   * Bits: each row's products run in K1's K order on K1's code, and each
//     ray's compositing, depth and feature sums in K1's order (the even
//     tiles' sums, K1's warpgroup 0, apart from the odd tiles', summed at
//     the end), so the outputs are the wgmma K1's bits.
//   * bf16 only, as the spike; the wrapper refuses fp32 on the card.

#pragma once

#include "fused_render_fwd_wgmma.cuh"

namespace {

constexpr int PP_TURN = 4;   // 4 + g: warpgroup g may issue its products
constexpr int PP_TOT0 = 6;   // P = 1: an even tile's total, warp 0s
constexpr int PP_TOT1 = 7;   // P = 1: an odd tile's total, warp 0s
constexpr int PP_END = 8;    // P = 1: warpgroup 1's sums of a ray are in

// K1's floats a warpgroup, with the feature sums [ray parity][tile
// parity][CP] in place of K1's [item parity][CP]
template <int HP, int CP>
__host__ __device__ constexpr int pp_floats() {
  return wg_floats<HP, CP>() + 2 * CP;
}

template <int WP, int HP, int CP>
__host__ __device__ constexpr int pp_fixed_bytes() {
  return 1024 + 1024 + 2 * (KEW / 64) * A_SLICE + 2 * (WP / 64) * A_SLICE +
         (2 * pp_floats<HP, CP>() + 16) * 4;
}

template <int WP, int HP, int CP>
__host__ __device__ constexpr int pp_ring_slots() {
  constexpr int n = (WG_SMEM_MAX - pp_fixed_bytes<WP, HP, CP>()) / (WP * 128);
  return n < WG_MAX_NS ? n : WG_MAX_NS;
}

template <int WP, int HP, int CP>
__host__ __device__ constexpr int pp_smem_bytes() {
  return pp_fixed_bytes<WP, HP, CP>() +
         pp_ring_slots<WP, HP, CP>() * WP * 128;
}

// Item i: rays [i P, i P + P). ``slots``: the 64-sample tiles each
// warpgroup runs an item.
template <int WP, int HP, int CP>
__global__ void __launch_bounds__(WG_THREADS, 1)
    pipe_render_wgmma_kernel(const KArgs a, const uint8_t* __restrict__ wpack,
                             const int P) {
  constexpr int SLOT = WP * 128;
  constexpr int NS = pp_ring_slots<WP, HP, CP>();
  constexpr int NF = pp_floats<HP, CP>();
  static_assert(NS >= 2, "no room for the weight ring");
  static_assert(WP % 64 == 0 && HP % 64 == 0 && CP % 64 == 0 && WP <= 256,
                "widths");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WG_MAX_NS;
  uint8_t* ring = smem + 1024;
  uint8_t* encb = ring + NS * SLOT;
  uint8_t* actb = encb + 2 * (KEW / 64) * A_SLICE;
  float* fl = reinterpret_cast<float*>(actb + 2 * (WP / 64) * A_SLICE);
  float* tot = fl + 2 * NF;    // [tile parity][warpgroup]
  float* depb = tot + 4;       // [ray parity][warpgroup][tile parity]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int S = a.S, L = a.L;
  const int nch = (S + WG_ROWS - 1) / WG_ROWS;   // 64-sample tiles a ray
  const int items = (a.N + P - 1) / P;
  const int slots = P == 1 ? (nch + 1) / 2 : (P + 1) / 2 * nch;

  if (tid >= 256) {  // ----------------------------------------- producer
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (tid != 256) return;
    Ring rg;
    // a phase's slices, once for each warpgroup, in the order of the turns
    auto twice = [&](uint32_t& off, int n, uint32_t bytes) {
      wg_put_run<NS, SLOT>(wpack, off, n, bytes, ring, full, empty, rg);
      wg_put_run<NS, SLOT>(wpack, off, n, bytes, ring, full, empty, rg);
      off += n * bytes;
    };
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      for (int k = 0; k < slots; ++k) {
        uint32_t off = 0;
        for (int i = 0; i < L; ++i)
          twice(off, wg_layer_slices<WP>(i, a.skip_mask), SLOT);
        twice(off, WP / 64, SIG_N * 128);
        twice(off, WP / 64, WP * 128);
        twice(off, WP / 64, HP * 128);
        twice(off, HP / 64, CP * 128);
      }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<WG_REGS_CONSUMER>();
  const int g = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const bool leader = wtid == 0;
  Ring rg;
  // The ring holds each phase's slices twice, warpgroup 0's then 1's: a
  // warpgroup walks every slot and reads its own. turn(n): the tensor
  // cores for a phase of n slices, past the slots the other reads (for
  // warpgroup 0 those of its own last phase, which warpgroup 1 read after
  // it; for warpgroup 1 this phase's, which warpgroup 0 read before it).
  int last_n = 0;
  auto wg_sync = [&]() { named_bar_sync(2 + g, 128); };
  auto turn = [&](int n) {
    named_bar_sync(PP_TURN + g, 256);
    const int skip = g == 0 ? last_n : n;
    for (int i = 0; i < skip; ++i) rg.next<NS>();
    last_n = n;
  };
  auto done = [&]() { named_bar_arrive(PP_TURN + 1 - g, 256); };
  auto nothing = [&]() {};
  if (g == 1) done();   // warpgroup 0 takes the first turn

  uint8_t* enc = encb + g * (KEW / 64) * A_SLICE;
  uint8_t* act = actb + g * (WP / 64) * A_SLICE;
  const uint32_t enc_a = smem_u32(enc), act_a = smem_u32(act);
  const uint32_t ring_a = smem_u32(ring);
  float* f = fl + g * NF;
  float* sig = f;
  float* zc = sig + WG_ROWS;
  float* nz = zc + WG_ROWS;
  float* dl = nz + WG_ROWS;
  float* wts = dl + WG_ROWS;
  float* xyz = wts + WG_ROWS;      // 64 x 3
  float* dirt = xyz + 3 * WG_ROWS; // HP
  float* fm = dirt + HP;           // [ray parity][tile parity][CP]
  float* red = fm + 4 * CP;        // [warp][CP]
  const float* fm1 = fl + NF + (fm - f);   // warpgroup 1's feature sums

  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int o_hf = L * WP, o_dd = o_hf + WP;

  int rp = 0;                  // parity of this warpgroup's rays
  float t_carry = 1.f;         // transmittance entering the tile (warp 0)
  float tot_e = 1.f;           // P >= 2: the ray's last even tile's total
  float dep_e = 0.f, dep_o = 0.f;   // depth sums of the even, odd tiles
  float acc[WP / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int nr_item = min(P, a.N - item * P);
    for (int k = 0; k < slots; ++k) {
      // this slot's ray (local jr) and tile c
      const int jr = P == 1 ? 0 : g + 2 * (k / nch);
      const int c = P == 1 ? 2 * k + g : k % nch;
      const bool ray_ok = jr < nr_item;
      const int ray = ray_ok ? item * P + jr : a.N - 1;
      const bool first = P == 1 ? k == 0 : c == 0;
      const bool last = P == 1 ? k == slots - 1 : c == nch - 1;
      const int par = c & 1;   // K1's warpgroup of this tile
      const int sb = c * WG_ROWS;
      if (first) {
        wg_dir_term<HP>(a, ray, dirt, wtid);
        for (int i = wtid; i < 2 * CP; i += 128) fm[rp * 2 * CP + i] = 0.f;
        t_carry = 1.f;
        dep_e = dep_o = 0.f;
      }
      const float* od = a.od + (size_t)ray * 8;
      const float o[3] = {od[0], od[1], od[2]};
      const float d[3] = {od[3], od[4], od[5]};
      wg_tile_encode(a, enc, xyz, zc, nz, dl, a.z + (size_t)ray * S,
                     a.noise + (size_t)ray * S, nullptr, o, d, sb, wtid,
                     wg_sync, nothing);

      // ---- trunk, sigma: a turn at the tensor cores for each product
      turn(wg_layer_slices<WP>(0, a.skip_mask));
      wg_trunk<WP, NS, SLOT>(
          a, acc, enc_a, act_a, act, ring_a, full, empty, rg, leader, r0, cq,
          wg_sync, nothing,
          [&](int i) {
            if (i < L - 1) turn(wg_layer_slices<WP>(i + 1, a.skip_mask));
          },
          done);
      turn(WP / 64);
      wg_sigma_head<WP, NS, SLOT>(a, act_a, sig, ring_a, full, empty, rg,
                                  leader, r0, lane, wg_sync, done);

      // ---- compositing, warp 0: K1's transmittance, tile by tile
      if (warp == 0) {
        float al[2], excl, total;
        wg_composite_scan(sig, nz, dl, ray_ok, sb, S, lane, al, excl, total);
        float t0_in;
        if (P == 1 && g == 0) {
          if (k > 0) {   // the ray's last odd tile is composited
            named_bar_sync(PP_TOT1, 64);
            const int q = (k - 1) & 1;
            t_carry = (t_carry * tot[q * 2]) * tot[q * 2 + 1];
          }
          t0_in = t_carry;
          if (lane == 0) tot[(k & 1) * 2] = total;
          named_bar_arrive(PP_TOT0, 64);
        } else if (P == 1) {
          named_bar_sync(PP_TOT0, 64);   // this tile's even half is
          const float te = tot[(k & 1) * 2];
          t0_in = t_carry * te;
          t_carry = (t_carry * te) * total;
          if (lane == 0) tot[(k & 1) * 2 + 1] = total;
          named_bar_arrive(PP_TOT1, 64);
        } else if (par == 0) {
          t0_in = t_carry;
          tot_e = total;
        } else {
          t0_in = t_carry * tot_e;
          t_carry = (t_carry * tot_e) * total;
        }
        const float pd = wg_composite_weights(
            t0_in, al, excl, zc, wts,
            (a.wout != nullptr && ray_ok) ? a.wout + (size_t)ray * S
                                          : nullptr,
            sb, S, lane);
        if (par == 0)
          dep_e += pd;
        else
          dep_o += pd;
      }

      wg_heads<WP, HP, CP, NS, SLOT>(
          a, acc, act, act_a, dirt, wts, red, fm + (rp * 2 + par) * CP,
          ring_a, full, empty, rg, leader, warp, lane, wtid, r0, cq, o_hf,
          o_dd, wg_sync, turn, done, nothing, [](int, int) {});

      if (!last) continue;
      // ---- the ray's block: [feature map | depth | 0], the even tiles'
      // sums (K1's warpgroup 0) plus the odd tiles'
      if (warp == 0 && lane == 0) {
        depb[(rp * 2 + g) * 2] = dep_e;
        depb[(rp * 2 + g) * 2 + 1] = dep_o;
      }
      const float* fe = fm + rp * 2 * CP;          // even tiles
      const float* fo = fe + CP;                   // odd tiles
      const float* de = depb + (rp * 2 + g) * 2;
      const float* dd = de + 1;
      bool writes = ray_ok;
      if (P == 1) {
        if (g == 1) {
          named_bar_arrive(PP_END, 256);
          writes = false;
        } else {
          if (warp == 0) named_bar_sync(PP_TOT1, 64);
          named_bar_sync(PP_END, 256);
          fo = fm1 + rp * 2 * CP + CP;
          dd = depb + (rp * 2 + 1) * 2 + 1;
        }
      } else {
        wg_sync();
      }
      if (writes && a.out != nullptr) {
        float* orow = a.out + (size_t)ray * a.ldo;
        for (int cc = wtid; cc < a.ldo; cc += 128) {
          float v = 0.f;
          if (cc < a.C) v = fe[cc] + fo[cc];
          else if (cc == a.C) v = *de + *dd;
          orow[cc] = v;
        }
      }
      rp ^= 1;
    }
  }
  if (g == 0) named_bar_sync(PP_TURN, 256);   // warpgroup 1's last
                                              // hand-over
}

// Launches pipe_render_wgmma_kernel<WP, HP, CP> on ``st`` over min(items,
// SMs) CTAs; cudaGetLastError().
template <int WP, int HP, int CP>
int launch_pipe_wgmma(const KArgs& a, const void* wpack, int P,
                      cudaStream_t st) {
  constexpr int smem = pp_smem_bytes<WP, HP, CP>();
  static_assert(smem <= WG_SMEM_MAX, "shared memory");
  auto kern = pipe_render_wgmma_kernel<WP, HP, CP>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int items = (a.N + P - 1) / P;
  kern<<<items < sms ? items : sms, WG_THREADS, smem, st>>>(
      a, static_cast<const uint8_t*>(wpack), P);
  return (int)cudaGetLastError();
}

}  // namespace
