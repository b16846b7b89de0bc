// Implicit-GEMM VALID convolution forward, NHWC, bf16 operands and fp32
// accumulation: out[n, h, w, o] = sum over (i, j, c) of
// x[n, h + i, w + j, c] * k[i, j, c, o], with x pre-padded
// (N, H + KH - 1, W + KW - 1, C), k (KH, KW, C, Co) HWIO and out
// (N, H, W, Co) at OutT.
//
// Replaces two Pallas TPU kernels of the conv spikes:
//   - scripts/spike_conv3x3.py:30 _fwd_kernel (conv3x3_valid_fwd, :49):
//     KH = KW = 3, out f32 (its preferred_element_type);
//   - scripts/spike_packed_conv.py:39 packed_conv_kernel
//     (pallas_packed_conv, :52): KH = KW = 2 over the space-to-depth
//     packed input (4C channels in, 4F out), out in the input's dtype.
// Both TPU kernels tile the output in r_tile-row blocks and get the halo
// through BlockSpecs: three row-shifted views of the input
// (spike_conv3x3.py:54-56), or a main block and a one-row halo block
// (spike_packed_conv.py:64-68). Both need H % r_tile == 0. Here a CTA
// computes its own coordinates and the ragged edge is masked (the mma.sync
// variant) or falls outside the tensor maps (the wgmma variant), so any
// N, H, W, C and Co work.
//
// Two variants, chosen by the wrapper (ops/conv.py conv_variant) from the
// shapes before the launch:
//
// conv_fwd_tma_kernel (C and Co multiples of 8: every row of x, k and out
// is 16-byte aligned, as TMA needs). A persistent grid, one CTA an SM,
// walks work items: an output tile of BH image rows x BW pixels (BW * BH =
// 128, ops/conv.py conv_tile picks BW from the width) times BN output
// channels. Warp 8 is the producer: one lane issues TMA loads into
// mbarrier rings in dynamic shared memory. Two consumer warpgroups each
// own 64 of the tile's pixels and run wgmma m64nBNk16 with both operands
// in shared memory, 128-byte swizzled (hopper.cuh). The depth is walked
// as (64-channel chunk, tap column j, tap row i):
//   - A: for each (chunk, j) one box of x, BH + KH - 1 rows x BW pixels
//     from column w0 + j. Row i of the taps is the same box BW * i rows
//     on, a whole number of 1024-byte atoms when BW % 8 == 0, so one load
//     serves KH taps and the K-major descriptor just moves;
//   - B: for each (chunk, j, i) the 64 x BN slice of k, MN-major as k
//     lies (N contiguous), BN / 64 boxes. When the whole kernel fits (RES:
//     S1's 9 x 64 x 64 bf16 = 72 KB) it is loaded once per CTA and stays;
//     else it streams through its own ring, NB slices deep;
//   - a product group (commit, then wait until one group is in flight) is
//     one x box's KH taps when the kernel stays, one tap when it streams;
//   - epilogue: each warpgroup writes its 64 x BN sums into a swizzled
//     staging buffer and one thread stores it with TMA (the box's part
//     past W, H or Co is not written), then goes on to the next item while
//     the store drains and the producer fills the x ring (as many slots as
//     227 KB leaves, up to TC_NX).
// BN is Co up to 256 for a bf16 output (S4 reads each input box once at 4C
// = 256, twice at 512) and 64 for the fp32 output (S1's 64 x 128 x 4
// bytes of staging a warpgroup; a wider f32 tile would not leave room for
// the ring).
// Why A comes this way. TMA's im2col mode would give one box per (chunk,
// tap) and re-read x KH * KW times, as the mma.sync variant does; A from
// registers (one halo window, ldmatrix at tap-shifted rows) reads x once
// but keeps the A fragments alive across asynchronous products, which the
// compiler does not see. A tiled box per tap column keeps both operands in
// shared memory and moves only descriptors, for KW (BH + KH - 1) / BH
// reads of x from L2 (3.4x for S1 at BW = 8, 2.1-2.3x for S4).
// What ptxas needs: no mbarrier wait between two wgmma of one group (a
// wait there is a divergent branch; ptxas then inserts warpgroup.arrive
// and serialises every wgmma of the function, note C7520, which
// chip_smoke.py's build phase refuses). The resident kernel is therefore
// waited for once, before the first item.
//
// conv_fwd_kernel (the mma.sync variant, C or Co not a multiple of 8):
// a block owns a 128-pixel x 64-channel output tile and walks the depth
// one (tap, 32 channels) chunk at a time, copied element by element into a
// 3-stage ring, ldmatrix feeding mma.sync m16n8k16; 8 warps, each 32
// pixels x 32 channels.
//
// What bounds it, on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// S1 at 16 x 160 x 224, 64 -> 64 is bound by bytes: 42.3 GFLOP against 222
// MB (75 MB of input read once, 147 MB of fp32 output written once),
// 0.066 ms. S4 at the two encoder levels (4C = 256 and 512) is bound by
// operations: 37.6 GFLOP each, 0.038 ms.
#pragma once

#include "fused_render_common.cuh"
#include "hopper.cuh"

namespace {

// ----------------------------------------------- the wgmma + TMA variant
constexpr int TC_BM = 128;             // output pixels a tile
constexpr int TC_THREADS = 288;        // two consumer warpgroups + producer
constexpr int TC_X_MAX = 24576;        // one x box: <= 192 rows of 128 B
constexpr int TC_B_BOX = 8192;         // 64 channels x 64 out, bf16
constexpr int TC_SMEM_MAX = 232448;    // the H100's 227 KB a block
constexpr int TC_BARS = 1024;          // room for the mbarriers
constexpr int TC_NX = 8;               // the most x slots

struct TcArgs {
  int BW, BH;
  int tiles_w, tiles_h, ntiles_n, cchunks, items;
  uint32_t x_bytes; // bytes of one x box
  int x_slot, nx;   // bytes of an x slot (x_bytes to 1024), slots
};

// Shared memory of an instance but its x ring: 1024 bytes to align the
// start, the barriers, NB B slots and the output staging.
template <typename OutT, int BN, int NB>
constexpr int tc_fixed_bytes() {
  return 1024 + TC_BARS + NB * (BN / 64) * TC_B_BOX +
         TC_BM * BN * (int)sizeof(OutT);
}

template <int BN>
__device__ __forceinline__ void tc_mma(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64k16<0, 1>(d, da, db);
  else
    wgmma_m64n256k16<0, 1>(d, da, db);
}

// RES: the whole kernel stays in shared memory (one column block, at most
// NB (chunk, tap) slices)
template <int KH, typename OutT, int BN, int NB, bool RES>
__global__ void __launch_bounds__(TC_THREADS, 1)
    conv_fwd_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap omap,
                        const TcArgs a) {
  constexpr int KW = KH;
  constexpr int B_SLOT = (BN / 64) * TC_B_BOX;
  static_assert(!RES || BN == 64, "a resident kernel is one 64-wide box");
  constexpr int ES = (int)sizeof(OutT);
  constexpr int O_BOX = 128 / ES;            // output channels a store box
  constexpr int WG_OUT = 64 * BN * ES;       // staging of one warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  static_assert(2 * (TC_NX + NB) * 8 <= TC_BARS, "barriers");
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem);
  uint64_t* xempty = xfull + TC_NX;
  uint64_t* bfull = xempty + TC_NX;
  uint64_t* bempty = bfull + NB;
  uint8_t* bsm = smem + TC_BARS;
  uint8_t* osm = bsm + NB * B_SLOT;
  uint8_t* xsm = osm + TC_BM * BN * ES;
  const int nx = a.nx;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < nx; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], 2);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // item -> (image, tile row, tile column, column block), column block
  // fastest so the CTAs of one pixel tile run side by side
  auto decode = [&](int item, int& n, int& h0, int& w0, int& n0) {
    n0 = (item % a.ntiles_n) * BN;
    int t = item / a.ntiles_n;
    w0 = (t % a.tiles_w) * a.BW;
    t /= a.tiles_w;
    h0 = (t % a.tiles_h) * a.BH;
    n = t / a.tiles_h;
  };

  if (tid >= 256) {  // ----------------------------------------- producer
    if (tid != 256) return;
    int xs = 0, xph = 0, bs = 0, bph = 0;
    if constexpr (RES) {  // the whole kernel, once: slot (chunk, j, i)
      for (int cc = 0; cc < a.cchunks; ++cc)
        for (int t = 0; t < KH * KW; ++t) {
          const int i = t % KH, j = t / KH, slot = cc * KH * KW + t;
          mbar_expect_tx(&bfull[slot], B_SLOT);
          tma_load_3d(bsm + slot * B_SLOT, &kmap, &bfull[slot], 0, cc * 64,
                      i * KW + j);
        }
    }
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      int n, h0, w0, n0;
      decode(item, n, h0, w0, n0);
      for (int cc = 0; cc < a.cchunks; ++cc)
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          mbar_wait(&xempty[xs], xph ^ 1);
          mbar_expect_tx(&xfull[xs], a.x_bytes);
          tma_load_4d(xsm + xs * a.x_slot, &xmap, &xfull[xs], cc * 64,
                      w0 + j, h0, n);
          if (++xs == nx) { xs = 0; xph ^= 1; }
          if constexpr (!RES) {
#pragma unroll
            for (int i = 0; i < KH; ++i) {
              mbar_wait(&bempty[bs], bph ^ 1);
              mbar_expect_tx(&bfull[bs], B_SLOT);
#pragma unroll
              for (int b = 0; b < BN / 64; ++b)
                tma_load_3d(bsm + bs * B_SLOT + b * TC_B_BOX, &kmap,
                            &bfull[bs], n0 + 64 * b, cc * 64, i * KW + j);
              if (++bs == NB) { bs = 0; bph ^= 1; }
            }
          }
        }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = wtid & 31;
  float acc[BN / 2];
  int xs = 0, xph = 0, bs = 0, bph = 0;
  uint8_t* ostage = osm + wg * WG_OUT;
  if constexpr (RES)  // once, outside the products: a wait between two
                      // wgmma of a group serialises them (ptxas C7520)
    for (int u = 0; u < a.cchunks * KH * KW; ++u) mbar_wait(&bfull[u], 0);
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    int n, h0, w0, n0;
    decode(item, n, h0, w0, n0);
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
    // the slots the previous product group read, released once it is
    // done. A group is all KH taps of an x box when the kernel stays, one
    // tap when it streams (its ring holds fewer than two x boxes' slices).
    int prev_b = -1, prev_x = -1;
    for (int cc = 0; cc < a.cchunks; ++cc)
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        mbar_wait(&xfull[xs], xph);
        const uint32_t xaddr = smem_u32(xsm + xs * a.x_slot) + wg * 64 * 128;
        if constexpr (RES) {
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < KH; ++i) {
            const uint32_t baddr =
                smem_u32(bsm + ((cc * KW + j) * KH + i) * B_SLOT);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              tc_mma<BN>(
                  acc, sw128_desc(xaddr + i * a.BW * 128 + kk * 32, 16, 1024),
                  sw128_desc(baddr + kk * 2048, TC_B_BOX, 1024));
          }
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();
          fence_acc(acc);
          if (wtid == 0 && prev_x >= 0) mbar_arrive(&xempty[prev_x]);
          prev_x = xs;
        } else {
#pragma unroll
          for (int i = 0; i < KH; ++i) {
            mbar_wait(&bfull[bs], bph);
            const uint32_t baddr = smem_u32(bsm + bs * B_SLOT);
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              tc_mma<BN>(
                  acc, sw128_desc(xaddr + i * a.BW * 128 + kk * 32, 16, 1024),
                  sw128_desc(baddr + kk * 2048, TC_B_BOX, 1024));
            wgmma_commit();
            fence_acc(acc);
            wgmma_wait<1>();
            fence_acc(acc);
            if (wtid == 0) {
              if (prev_b >= 0) mbar_arrive(&bempty[prev_b]);
              if (prev_x >= 0) mbar_arrive(&xempty[prev_x]);
            }
            prev_b = bs;
            prev_x = i == KH - 1 ? xs : -1;
            if (++bs == NB) { bs = 0; bph ^= 1; }
          }
        }
        if (++xs == nx) { xs = 0; xph ^= 1; }
      }
    wgmma_wait<0>();
    fence_acc(acc);
    if (wtid == 0) {
      if (prev_b >= 0) mbar_arrive(&bempty[prev_b]);
      if (prev_x >= 0) mbar_arrive(&xempty[prev_x]);
      bulk_wait_read();  // the previous item's store has left the staging
    }
    named_bar_sync(1 + wg, 128);
    // rows warp * 16 + lane / 4 (+ 8), columns 8 nb + 2 (lane % 4) (+ 1),
    // into 128-byte swizzled boxes of O_BOX channels
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 16 + (lane >> 2) + 8 * hf;
        const int c = nb * 8 + 2 * (lane & 3);
        const int byte = (c % O_BOX) * ES;
        uint8_t* p = ostage + (c / O_BOX) * TC_B_BOX + r * 128 +
                     ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
        const float v0 = acc[nb * 4 + 2 * hf], v1 = acc[nb * 4 + 2 * hf + 1];
        if constexpr (ES == 4)
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(v0, v1);
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (wtid == 0) {
#pragma unroll
      for (int b = 0; b < BN / O_BOX; ++b)
        tma_store_4d(&omap, ostage + b * TC_B_BOX, n0 + b * O_BOX, w0,
                     h0 + wg * (64 / a.BW), n);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

// Launches conv_fwd_tma_kernel on ``st`` over min(items, SMs) CTAs;
// cudaGetLastError().
template <int KH, typename OutT, int BN, int NB, bool RES>
int launch_conv_fwd_tma(const CUtensorMap& xmap, const CUtensorMap& kmap,
                        const CUtensorMap& omap, const TcArgs& a,
                        cudaStream_t st) {
  constexpr int fixed = tc_fixed_bytes<OutT, BN, NB>();
  static_assert(fixed + 2 * TC_X_MAX <= TC_SMEM_MAX, "no room for 2 slots");
  const int smem = fixed + a.nx * a.x_slot;
  auto kern = conv_fwd_tma_kernel<KH, OutT, BN, NB, RES>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = a.items < sms ? a.items : sms;
  kern<<<grid, TC_THREADS, smem, st>>>(xmap, kmap, omap, a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the mma.sync variant
constexpr int CV_BM = 128;      // output pixels a block
constexpr int CV_BN = 64;       // output channels a block
constexpr int CV_BK = 32;       // depth a stage: 32 channels of one tap
constexpr int CV_STAGES = 3;
constexpr int CV_THREADS = 256;
constexpr int CV_LDA = CV_BK + 8;  // 80-byte rows: conflict-free ldmatrix
constexpr int CV_LDB = CV_BN + 8;

struct ConvArgs {
  const __nv_bfloat16* x;  // (N, Hp, Wp, C)
  const __nv_bfloat16* k;  // (KH, KW, C, Co)
  void* out;               // (N, H, W, Co)
  int N, H, W, C, Co, Hp, Wp;
};

template <int KH, int KW, typename OutT>
__global__ void __launch_bounds__(CV_THREADS)
    conv_fwd_kernel(const ConvArgs a) {
  __shared__ __align__(16) __nv_bfloat16 As[CV_STAGES][CV_BM * CV_LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[CV_STAGES][CV_BK * CV_LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int M = a.N * a.H * a.W;
  const int m0 = blockIdx.x * CV_BM;
  const int n0 = blockIdx.y * CV_BN;
  const int cchunks = (a.C + CV_BK - 1) / CV_BK;
  const int nchunks = KH * KW * cchunks;

  // this thread copies 8 channels (vector av) of pixel rows ar and ar + 64
  // of the A tile, and 8 columns (vector bv) of row br of the B tile
  const int ar = tid >> 2, av = (tid & 3) * 8;
  const int br = tid >> 3, bv = (tid & 7) * 8;
  size_t a_base[2];
  bool a_ok[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int m = m0 + ar + 64 * q;
    a_ok[q] = m < M;
    const int mm = a_ok[q] ? m : 0;
    const int w = mm % a.W, t = mm / a.W, h = t % a.H, n = t / a.H;
    a_base[q] = (((size_t)n * a.Hp + h) * a.Wp + w) * a.C;
  }

  auto load = [&](int kc, int stage) {
    const int tap = kc / cchunks, c0 = (kc % cchunks) * CV_BK;
    const int i = tap / KW, j = tap % KW;
    const size_t tap_off = ((size_t)i * a.Wp + j) * a.C;
    __nv_bfloat16* as = As[stage];
    __nv_bfloat16* bs = Bs[stage];
    const int bc = c0 + br, bo = n0 + bv;
    const __nv_bfloat16* bsrc = a.k + ((size_t)tap * a.C + bc) * a.Co + bo;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + av + u;
        as[(ar + 64 * q) * CV_LDA + av + u] =
            a_ok[q] && c < a.C ? a.x[a_base[q] + tap_off + c]
                               : __float2bfloat16_rn(0.f);
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      bs[br * CV_LDB + bv + u] = bc < a.C && bo + u < a.Co
                                     ? bsrc[u]
                                     : __float2bfloat16_rn(0.f);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < CV_STAGES - 1; ++s)
    if (s < nchunks) load(s, s);
  for (int kc = 0; kc < nchunks; ++kc) {
    __syncthreads();  // chunk kc is written and every warp is done with
                      // kc - 1
    const int nxt = kc + CV_STAGES - 1;
    if (nxt < nchunks) load(nxt, nxt % CV_STAGES);
    const __nv_bfloat16* as = As[kc % CV_STAGES];
    const __nv_bfloat16* bs = Bs[kc % CV_STAGES];
#pragma unroll
    for (int kk = 0; kk < CV_BK / 16; ++kk) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * CV_LDA +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldmatrix_x4_trans(
            bf[pr], bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             CV_LDB +
                        wn * 32 + pr * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma16816(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

  OutT* out = static_cast<OutT*>(a.out);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm * 32 + mi * 16 + g + hf * 8;
      if (row >= M) continue;
      OutT* orow = out + (size_t)row * a.Co;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
        if (col < a.Co) orow[col] = to_t<OutT>(v0);
        if (col + 1 < a.Co) orow[col + 1] = to_t<OutT>(v1);
      }
    }
}

// Launches conv_fwd_kernel<KH, KW, OutT> on ``st``; cudaGetLastError().
template <int KH, int KW, typename OutT>
int launch_conv_fwd(const ConvArgs& a, cudaStream_t st) {
  const int M = a.N * a.H * a.W;
  const dim3 grid((M + CV_BM - 1) / CV_BM, (a.Co + CV_BN - 1) / CV_BN);
  conv_fwd_kernel<KH, KW, OutT><<<grid, CV_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
