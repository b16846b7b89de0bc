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
// (spike_packed_conv.py:64-68). Both need H % r_tile == 0:
// conv3x3_valid_fwd's grid is h // r_tile and leaves the remaining rows
// unwritten, pallas_packed_conv asserts it. Here a block computes its own
// addresses from blockIdx and the shapes and masks the ragged edge, so any
// N, H, W, C and Co work.
//
// GEMM view: M = N*H*W output pixels (rows), Co columns, a depth of
// KH*KW*C ordered (tap, channel). A block owns a 128-pixel x 64-channel
// output tile; Co is tiled over blockIdx.y. It walks the depth one (tap,
// 32 channels) chunk at a time: each pixel's 32 channels of the shifted
// input row are copied straight from the padded tensor (16-byte cp.async,
// zero-filled past C and past M), the chunk's 32 x 64 slice of k beside
// them, through a 3-stage ring in shared memory; ldmatrix feeds mma.sync
// m16n8k16. 8 warps, each 32 pixels x 32 channels (32 fp32 sums a thread).
// When C or Co is not a multiple of 8 the copies are element by element
// (VEC = false): 16-byte copies would straddle pixels.
//
// What bounds it, on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// S1 at 8 x 160 x 224, 64 -> 64 is bound by bytes: 21.1 GFLOP against 111
// MB (37.5 MB of input read once, 73.4 MB of fp32 output written once),
// 0.033 ms. S4 at the two encoder levels (4C = 256 and 512) is bound by
// operations: 37.6 GFLOP each, 0.038 ms. The design reads the input from
// device memory about once per column block (the 9 or 4 shifted reads of
// a pixel's row come from L1/L2) and writes each output once, from
// registers, 8 bytes a thread. It runs mma.sync, which on Hopper reaches a
// fraction of the wgmma rate: S4 stays far from its bound.
// Left for later: wgmma with TMA loads, a persistent grid, a 128-wide
// column tile for Co >= 128 (each input tile is now read Co / 64 times).
#pragma once

#include "fused_render_common.cuh"

namespace {

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

template <int KH, int KW, typename OutT, bool VEC>
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
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool ok = a_ok[q] && c0 + av < a.C;
        cp_async16(as + (ar + 64 * q) * CV_LDA + av,
                   ok ? a.x + a_base[q] + tap_off + c0 + av : a.x,
                   ok ? 16 : 0);
      }
      const bool ok = bc < a.C && bo < a.Co;
      cp_async16(bs + br * CV_LDB + bv, ok ? bsrc : a.k, ok ? 16 : 0);
    } else {
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
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < CV_STAGES - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<CV_STAGES - 2>();  // chunk kc has landed
    __syncthreads();                 // and every warp is done with kc - 1
    const int nxt = kc + CV_STAGES - 1;
    if (nxt < nchunks) load(nxt, nxt % CV_STAGES);
    cp_async_commit();
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
  cp_async_wait<0>();

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
        if constexpr (VEC) {
          if (col < a.Co) store2<OutT>(orow + col, v0, v1);
        } else {
          if (col < a.Co) orow[col] = to_t<OutT>(v0);
          if (col + 1 < a.Co) orow[col + 1] = to_t<OutT>(v1);
        }
      }
    }
}

// Launches conv_fwd_kernel<KH, KW, OutT, *> on ``st``; cudaGetLastError().
template <int KH, int KW, typename OutT>
int launch_conv_fwd(const ConvArgs& a, bool vec, cudaStream_t st) {
  const int M = a.N * a.H * a.W;
  const dim3 grid((M + CV_BM - 1) / CV_BM, (a.Co + CV_BN - 1) / CV_BN);
  if (vec)
    conv_fwd_kernel<KH, KW, OutT, true><<<grid, CV_THREADS, 0, st>>>(a);
  else
    conv_fwd_kernel<KH, KW, OutT, false><<<grid, CV_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
