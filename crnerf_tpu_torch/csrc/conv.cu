// The conv spikes' library: the implicit-GEMM forward of conv_fwd.cuh at
// its two instances (3x3 -> f32, 2x2 -> bf16) and the 3x3 weight gradient,
// each in two variants (wgmma + TMA; mma.sync), chosen by the wrapper
// (ops/conv.py conv_variant) from the shapes before the launch.
//
// Weight gradient: dK[i, j, c, o] = sum over (n, h, w) of
// x[n, h + i, w + j, c] * dy[n, h, w, o], x the padded input
// (N, H + 2, W + 2, C) and dy (N, H, W, Co), both bf16; dK (3, 3, C, Co)
// fp32. Nine (C x Co) products with a reduction depth of N*H*W (573,440 at
// enc_a's conv3 in the train step, 16 x 160 x 224).
//
// Replaces scripts/spike_conv3x3.py:74 _dw_kernel (conv3x3_dw, :98). That
// kernel adds every row tile's nine products into one VMEM output block
// across a sequential grid (:76-80); CTAs on this card run in parallel and
// in no order, so the sum is split over pixel slices (split-K) and
// conv_reduce_kernel sums the slices' partial gradients in index order.
// Every sum has a fixed order, so two runs on the same inputs give the
// same bits, without atomics.
//
// conv_dw_tma_kernel (C and Co multiples of 8): a CTA takes one slice of
// the pixel tiles (BH rows x BW pixels, BW * BH = 128, as the forward's;
// ops/conv.py dw_slices) and one 64 x 64 (channel in x out) block, and
// computes all nine taps of it. A producer warp loads, per tile, the dy
// box (128 pixels x 64 out) and three x boxes (BH + 2 rows x BW pixels
// from column w0 + j, j = 0, 1, 2) by TMA into an mbarrier ring.
// Three consumer warpgroups, one a tap column j, each hold three 64 x 64
// fp32 accumulators (taps (0, j), (1, j), (2, j): 96 registers a thread)
// and run wgmma m64n64k16 with A = x^T (the box as it lies, channels
// contiguous: MN-major, row i of the taps BW * i rows on) and B = dy
// (MN-major), the tile's pixels the reduction. x and dy are read from
// device memory once and from L2 (3 (BH + 2) / BH + 1) times, not 18. The
// ring has as many stages as 227 KB holds, up to 4 (3 at BW = 8). A comes
// from shared memory by descriptor, not by ldmatrix.trans into registers:
// wgmma takes an MN-major A for bf16, so the box serves as it lies and no
// register fragment has to outlive an asynchronous product.
//
// conv_dw_kernel (the mma.sync variant, C or Co not a multiple of 8): one
// block per (tap, 64 x 64 tile, pixel slice), 64 pixels a stage copied
// element by element into a double-buffered pair of tiles; ldmatrix.trans
// gives both operands of mma.sync m16n8k16. 4 warps, each 32 x 32.
//
// What bounds it, on an H100 SXM: 42.3 GFLOP (0.043 ms at 989 TFLOP/s)
// against 148 MB (75 MB of x and 73 MB of dy, each read once; 0.044 ms at
// 3.35 TB/s) at 16 x 160 x 224: bytes, by a hair. The partial gradients
// (slices x 9 x C x Co fp32, 19 MB at 132 slices) are written and read
// once more by the reduce, which loads eight slices ahead and adds them in
// index order.

#include "conv_fwd.cuh"

namespace {

// ----------------------------------------------- the wgmma + TMA variant
constexpr int DT_THREADS = 416;   // three consumer warpgroups + producer
constexpr int DT_MAX_STAGES = 4;
constexpr int DT_D_SLOT = 16384;  // one dy box: 128 pixels x 64 out
static_assert(1024 + TC_BARS + 2 * (3 * TC_X_MAX + DT_D_SLOT) <=
                  TC_SMEM_MAX, "no room for 2 stages");

struct DtArgs {
  float* part;  // (slices, 9 * C * Co)
  int C, Co, BW, BH, tiles_w, tiles_h, tiles, otiles;
  uint32_t x_bytes;           // bytes of one x box
  int x_slot, stages;         // x_bytes to 1024; stages in the ring
};

__global__ void __launch_bounds__(DT_THREADS, 1)
    conv_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const DtArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + DT_MAX_STAGES;
  uint8_t* ring = smem + TC_BARS;
  const int stage_bytes = 3 * a.x_slot + DT_D_SLOT;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 3);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int c0 = (blockIdx.y / a.otiles) * 64;
  const int o0 = (blockIdx.y % a.otiles) * 64;
  // slice blockIdx.x of gridDim.x: tiles [s * tiles / S, (s + 1) * tiles / S)
  const int t_begin = (int)((long long)blockIdx.x * a.tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * a.tiles / gridDim.x);

  if (tid >= 384) {  // ----------------------------------------- producer
    if (tid != 384) return;
    int s = 0, ph = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int w0 = (t % a.tiles_w) * a.BW;
      const int h0 = (t / a.tiles_w % a.tiles_h) * a.BH;
      const int n = t / (a.tiles_w * a.tiles_h);
      uint8_t* st = ring + s * stage_bytes;
      mbar_wait(&empty[s], ph ^ 1);
      mbar_expect_tx(&full[s], 3 * a.x_bytes + DT_D_SLOT);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        tma_load_4d(st + j * a.x_slot, &xmap, &full[s], c0, w0 + j, h0, n);
      tma_load_4d(st + 3 * a.x_slot, &dmap, &full[s], o0, w0, h0, n);
      if (++s == a.stages) { s = 0; ph ^= 1; }
    }
    return;
  }

  // ----------------------------------- consumers: warpgroup j = tap column
  const int j = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = wtid & 31;
  float acc[3][32];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[i][q] = 0.f;
  int s = 0, ph = 0, prev = -1;
  for (int t = t_begin; t < t_end; ++t) {
    mbar_wait(&full[s], ph);
    const uint32_t xaddr = smem_u32(ring + s * stage_bytes + j * a.x_slot);
    const uint32_t daddr = smem_u32(ring + s * stage_bytes + 3 * a.x_slot);
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_acc(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = sw128_desc(daddr + kk * 2048, TC_B_BOX, 1024);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        wgmma_m64n64k16<1, 1>(
            acc[i],
            sw128_desc(xaddr + i * a.BW * 128 + kk * 2048, TC_B_BOX, 1024),
            db);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_acc(acc[i]);
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_acc(acc[i]);
    if (wtid == 0 && prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == a.stages) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 3; ++i) fence_acc(acc[i]);

  // rows (channels in) warp * 16 + lane / 4 (+ 8), columns (out)
  // 8 nb + 2 (lane % 4) (+ 1); Co % 8 == 0, so a pair is in or out whole
  const size_t cco = (size_t)a.C * a.Co;
  float* part = a.part + blockIdx.x * 9 * cco;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float* out = part + (i * 3 + j) * cco;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + warp * 16 + (lane >> 2) + 8 * hf;
      if (c >= a.C) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int o = o0 + nb * 8 + 2 * (lane & 3);
        if (o < a.Co)
          *reinterpret_cast<float2*>(out + (size_t)c * a.Co + o) =
              make_float2(acc[i][nb * 4 + 2 * hf],
                          acc[i][nb * 4 + 2 * hf + 1]);
      }
    }
  }
}

// ------------------------------------------------ the mma.sync variant
constexpr int DW_T = 64;        // output tile: 64 channels in x 64 out
constexpr int DW_PT = 64;       // pixels a stage
constexpr int DW_LD = DW_T + 8;
constexpr int DW_THREADS = 128;

struct DwArgs {
  const __nv_bfloat16* x;   // (N, Hp, Wp, C)
  const __nv_bfloat16* dy;  // (N, H, W, Co)
  float* part;              // (splits, 9 * C * Co)
  int N, H, W, C, Co, Hp, Wp, ctiles, otiles, m_per;
};

__global__ void __launch_bounds__(DW_THREADS)
    conv_dw_kernel(const DwArgs a) {
  __shared__ __align__(16) __nv_bfloat16 Xs[2][DW_PT * DW_LD];
  __shared__ __align__(16) __nv_bfloat16 Ds[2][DW_PT * DW_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int ot = blockIdx.x % a.otiles;
  const int ct = (blockIdx.x / a.otiles) % a.ctiles;
  const int tap = blockIdx.x / (a.otiles * a.ctiles);
  const int i = tap / 3, j = tap % 3;
  const int c0 = ct * DW_T, o0 = ot * DW_T;
  const int M = a.N * a.H * a.W;
  const int m_begin = blockIdx.y * a.m_per;
  const int m_end = min(M, m_begin + a.m_per);
  const int nsteps = (m_end - m_begin + DW_PT - 1) / DW_PT;
  const size_t tap_off = ((size_t)i * a.Wp + j) * a.C;

  // this thread copies 8 columns (v) of pixel rows r0, r0 + 16, +32, +48
  const int r0 = tid >> 3, v = (tid & 7) * 8;
  auto load = [&](int step, int stage) {
    __nv_bfloat16* xs = Xs[stage];
    __nv_bfloat16* ds = Ds[stage];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 16 * q;
      const int m = m_begin + step * DW_PT + r;
      const bool row_ok = m < m_end;
      const int mm = row_ok ? m : 0;
      const int w = mm % a.W, t = mm / a.W, h = t % a.H, n = t / a.H;
      const __nv_bfloat16* xsrc =
          a.x + (((size_t)n * a.Hp + h) * a.Wp + w) * a.C + tap_off + c0 + v;
      const __nv_bfloat16* dsrc = a.dy + (size_t)mm * a.Co + o0 + v;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xs[r * DW_LD + v + u] = row_ok && c0 + v + u < a.C
                                    ? xsrc[u]
                                    : __float2bfloat16_rn(0.f);
        ds[r * DW_LD + v + u] = row_ok && o0 + v + u < a.Co
                                    ? dsrc[u]
                                    : __float2bfloat16_rn(0.f);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  if (nsteps > 0) load(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) load(s + 1, (s + 1) & 1);
    __syncthreads();
    const __nv_bfloat16* xs = Xs[s & 1];
    const __nv_bfloat16* ds = Ds[s & 1];
    const int mj = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < DW_PT / 16; ++kk) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], xs + (kk * 16 + (mj >> 1) * 8 + r) * DW_LD +
                                      wm * 32 + mi * 16 + (mj & 1) * 8);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
        ldmatrix_x4_trans(bf[pr], ds + (kk * 16 + (mj & 1) * 8 + r) * DW_LD +
                                      wn * 32 + pr * 16 + (mj >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma16816(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  const size_t total = (size_t)9 * a.C * a.Co;
  float* out = a.part + blockIdx.y * total + (size_t)tap * a.C * a.Co;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + wm * 32 + mi * 16 + g + hf * 8;
      if (c >= a.C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = o0 + wn * 32 + ni * 8 + 2 * t;
        float* p = out + (size_t)c * a.Co + o;
        if (o < a.Co) p[0] = acc[mi][ni][2 * hf];
        if (o + 1 < a.Co) p[1] = acc[mi][ni][2 * hf + 1];
      }
    }
}

// out[i] = part[0][i] + part[1][i] + ... in index order (eight loads in
// flight, the adds in the same order)
__global__ void conv_reduce_kernel(const float* __restrict__ part,
                                   int n_parts, long long total,
                                   float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  int p = 0;
  for (; p + 8 <= n_parts; p += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(size_t)(p + u) * total + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; p < n_parts; ++p) s += part[(size_t)p * total + i];
  out[i] = s;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the output tile widths the TMA variants take (ops/conv.py conv_tile):
// BW % 8 == 0 keeps a tap row's shift on whole swizzle atoms, and the x
// box, BH + KH - 1 rows of BW pixels, within TC_X_MAX
bool tile_ok(int bw, int kh) {
  return (bw == 8 || bw == 16 || bw == 32 || (bw == 64 && kh == 2)) &&
         (128 / bw + kh - 1) * bw * 128 <= TC_X_MAX;
}

// bytes of a box's slot: a whole number of 1024-byte swizzle atoms
int slot_bytes(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// Encodes the forward's three maps and launches the instance for KH and
// Co (TcArgs and the maps as conv_fwd.cuh describes them).
template <int KH, typename OutT, int BN, int NB>
int conv_fwd_tma(const void* x, const void* k, void* out, int N, int Hp,
                 int Wp, int C, int Co, int bw, cudaStream_t st) {
  const int H = Hp - KH + 1, W = Wp - KH + 1, bh = 128 / bw;
  constexpr int ES = (int)sizeof(OutT);
  CUtensorMap xmap, kmap, omap;
  const long long xd[4] = {C, Wp, Hp, N}, kd[3] = {Co, C, KH * KH},
                  od[4] = {Co, W, H, N};
  const int xb[4] = {64, bw, bh + KH - 1, 1}, kb[3] = {64, 64, 1},
            ob[4] = {128 / ES, bw, 64 / bw, 1};
  const CUtensorMapDataType ot = ES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, 4, xd,
                      xb);
  if (!rc) rc = encode_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, 3,
                           kd, kb);
  if (!rc) rc = encode_map(&omap, ot, ES, out, 4, od, ob);
  if (rc) return rc;
  TcArgs a = {};
  a.BW = bw; a.BH = bh;
  a.tiles_w = (W + bw - 1) / bw;
  a.tiles_h = (H + bh - 1) / bh;
  a.ntiles_n = (Co + BN - 1) / BN;
  a.cchunks = (C + 63) / 64;
  const long long items = (long long)N * a.tiles_h * a.tiles_w * a.ntiles_n;
  // item += gridDim.x must not overflow
  if (items > 2147483647LL - 65536) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  a.x_bytes = (uint32_t)(128 * bw * (bh + KH - 1));
  a.x_slot = slot_bytes((int)a.x_bytes);
  a.nx = (TC_SMEM_MAX - tc_fixed_bytes<OutT, BN, NB>()) / a.x_slot;
  if (a.nx > TC_NX) a.nx = TC_NX;
  if constexpr (KH * KH <= NB) {
    if (a.ntiles_n == 1 && a.cchunks * KH * KH <= NB)
      return launch_conv_fwd_tma<KH, OutT, BN, NB, true>(xmap, kmap, omap,
                                                         a, st);
  }
  return launch_conv_fwd_tma<KH, OutT, BN, NB, false>(xmap, kmap, omap, a,
                                                      st);
}

}  // namespace

// ptrs (host array): x (N, Hp, Wp, C) bf16, k (KH, KW, C, Co) bf16, out
// (N, Hp - KH + 1, Wp - KW + 1, Co). dims: N, Hp, Wp, C, Co, KH, variant,
// BW. KH = 3 (a 3x3 kernel) writes fp32, KH = 2 (a 2x2 kernel) bf16.
// variant 1: the wgmma + TMA kernel with output tiles of 128 / BW rows of
// BW pixels (C and Co multiples of 8, pointers 16-byte aligned); variant 0:
// the mma.sync kernel (BW unused). Launches on ``stream`` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// does not take, or the CUresult of a tensor map it could not encode).
extern "C" int crnerf_conv_fwd(const void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  if (n_ptrs != 3 || n_dims != 8) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const int N = dims[0], Hp = dims[1], Wp = dims[2], C = dims[3],
            Co = dims[4], kh = dims[5], variant = dims[6], bw = dims[7];
  if ((kh != 2 && kh != 3) || N < 1 || C < 1 || Co < 1 || Hp < kh ||
      Wp < kh || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const int H = Hp - kh + 1, W = Wp - kh + 1;
  const long long M = (long long)N * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (C % 8 || Co % 8 || !tile_ok(bw, kh) || !aligned16(ptrs[0]) ||
        !aligned16(ptrs[1]) || !aligned16(ptrs[2]))
      return (int)cudaErrorInvalidValue;
    if (kh == 3)
      return conv_fwd_tma<3, float, 64, 9>(ptrs[0], ptrs[1],
                                              const_cast<void*>(ptrs[2]), N,
                                              Hp, Wp, C, Co, bw, st);
    if (Co <= 64)
      return conv_fwd_tma<2, __nv_bfloat16, 64, 9>(
          ptrs[0], ptrs[1], const_cast<void*>(ptrs[2]), N, Hp, Wp, C, Co, bw,
          st);
    return conv_fwd_tma<2, __nv_bfloat16, 256, 3>(
        ptrs[0], ptrs[1], const_cast<void*>(ptrs[2]), N, Hp, Wp, C, Co, bw,
        st);
  }
  ConvArgs a = {};
  a.N = N; a.Hp = Hp; a.Wp = Wp; a.C = C; a.Co = Co; a.H = H; a.W = W;
  if (M + CV_BM > 2147483647LL || (a.Co + CV_BN - 1) / CV_BN > 65535)
    return (int)cudaErrorInvalidValue;
  a.x = (const __nv_bfloat16*)ptrs[0];
  a.k = (const __nv_bfloat16*)ptrs[1];
  a.out = const_cast<void*>(ptrs[2]);
  if (kh == 3) return launch_conv_fwd<3, 3, float>(a, st);
  return launch_conv_fwd<2, 2, __nv_bfloat16>(a, st);
}

// ptrs (host array): x (N, Hp, Wp, C) bf16, dy (N, Hp - 2, Wp - 2, Co)
// bf16, part (splits x 9*C*Co) fp32 scratch, out (3, 3, C, Co) fp32.
// dims: N, Hp, Wp, C, Co, splits, per, variant, BW. variant 1: the wgmma +
// TMA kernel on (splits, C-tiles * Co-tiles) CTAs, CTA (s, .) over pixel
// tiles [s * T / splits, (s + 1) * T / splits) of the T tiles of 128 / BW
// rows x BW pixels (C and Co multiples of 8, pointers 16-byte aligned,
// splits <= T; per unused); variant 0: the mma.sync kernel on (9 *
// C-tiles * Co-tiles, splits) blocks, block (., s) over pixels
// [s * per, (s + 1) * per) (BW unused). Then the fixed-order sum of the
// splits into out. Returns cudaGetLastError() (or cudaErrorInvalidValue,
// or the CUresult of a tensor map it could not encode).
extern "C" int crnerf_conv_dw(const void* const* ptrs, int n_ptrs,
                              const int* dims, int n_dims, void* stream) {
  if (n_ptrs != 4 || n_dims != 9) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const int N = dims[0], Hp = dims[1], Wp = dims[2], C = dims[3],
            Co = dims[4], splits = dims[5], per = dims[6], variant = dims[7],
            bw = dims[8];
  if (N < 1 || C < 1 || Co < 1 || Hp < 3 || Wp < 3 || splits < 1 ||
      (variant == 0 && per < 1) || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const int H = Hp - 2, W = Wp - 2;
  const long long M = (long long)N * H * W;
  const int ctiles = (C + 63) / 64, otiles = (Co + 63) / 64;
  float* part = (float*)ptrs[2];
  float* out = (float*)ptrs[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (C % 8 || Co % 8 || !tile_ok(bw, 3) || !aligned16(ptrs[0]) ||
        !aligned16(ptrs[1]) || !aligned16(ptrs[2]) ||
        (long long)ctiles * otiles > 65535)
      return (int)cudaErrorInvalidValue;
    DtArgs a = {};
    a.part = part;
    a.C = C; a.Co = Co; a.BW = bw; a.BH = 128 / bw;
    a.tiles_w = (W + bw - 1) / bw;
    a.tiles_h = (H + a.BH - 1) / a.BH;
    const long long tiles = (long long)N * a.tiles_w * a.tiles_h;
    if (tiles > 2147483647LL || splits > tiles)
      return (int)cudaErrorInvalidValue;
    a.tiles = (int)tiles;
    a.otiles = otiles;
    a.x_bytes = (uint32_t)(128 * bw * (a.BH + 2));
    a.x_slot = slot_bytes((int)a.x_bytes);
    const int fixed = 1024 + TC_BARS;
    a.stages = (TC_SMEM_MAX - fixed) / (3 * a.x_slot + DT_D_SLOT);
    if (a.stages > DT_MAX_STAGES) a.stages = DT_MAX_STAGES;
    const int smem = fixed + a.stages * (3 * a.x_slot + DT_D_SLOT);
    CUtensorMap xmap, dmap;
    const long long xd[4] = {C, Wp, Hp, N}, dd[4] = {Co, W, H, N};
    const int xb[4] = {64, bw, a.BH + 2, 1}, db[4] = {64, bw, a.BH, 1};
    int rc = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptrs[0],
                        4, xd, xb);
    if (!rc) rc = encode_map(&dmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             ptrs[1], 4, dd, db);
    if (rc) return rc;
    const cudaError_t e = cudaFuncSetAttribute(
        conv_dw_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    conv_dw_tma_kernel<<<dim3(splits, ctiles * otiles), DT_THREADS, smem,
                         st>>>(xmap, dmap, a);
  } else {
    if (M > 2147483647LL - DW_PT || splits > 65535 ||
        (long long)per * splits < M || (long long)per * (splits - 1) >= M)
      return (int)cudaErrorInvalidValue;
    DwArgs a = {};
    a.N = N; a.Hp = Hp; a.Wp = Wp; a.C = C; a.Co = Co; a.H = H; a.W = W;
    a.ctiles = ctiles;
    a.otiles = otiles;
    a.m_per = per;
    a.x = (const __nv_bfloat16*)ptrs[0];
    a.dy = (const __nv_bfloat16*)ptrs[1];
    a.part = part;
    conv_dw_kernel<<<dim3(9 * ctiles * otiles, splits), DW_THREADS, 0, st>>>(
        a);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = 9LL * C * Co;
  conv_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, splits, total, out);
  return (int)cudaGetLastError();
}
