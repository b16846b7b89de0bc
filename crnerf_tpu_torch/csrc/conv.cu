// The conv spikes' library: the implicit-GEMM forward of conv_fwd.cuh at
// its two instances (3x3 -> f32, 2x2 -> bf16) and the 3x3 weight gradient.
//
// Weight gradient: dK[i, j, c, o] = sum over (n, h, w) of
// x[n, h + i, w + j, c] * dy[n, h, w, o], x the padded input
// (N, H + 2, W + 2, C) and dy (N, H, W, Co), both bf16; dK (3, 3, C, Co)
// fp32. Nine (C x Co) products with a reduction depth of N*H*W (286,720 at
// the spike's 8 x 160 x 224).
//
// Replaces scripts/spike_conv3x3.py:74 _dw_kernel (conv3x3_dw, :98). That
// kernel adds every row tile's nine products into one VMEM output block
// across a sequential grid (:76-80); blocks on this card run in parallel
// and in no order, so the sum is split: conv_dw_kernel takes one
// 64 x 64 tile of one tap's (C x Co) product over one slice of the pixels
// (split-K, as fused_render_bwd.cuh's wgrad_bf16_kernel) and writes a
// partial tile; conv_reduce_kernel sums the slices in index order. Every
// sum has a fixed order, so two runs on the same inputs give the same
// bits, without atomics. Within a slice, 64 pixels a stage: the pixel
// rows of x shifted by the tap and of dy are copied with 16-byte cp.async
// (zero-filled past the slice, past C and past Co; element by element when
// C or Co is not a multiple of 8) into a double-buffered pair of tiles, and
// ldmatrix.trans gives both operands of mma.sync m16n8k16 (the pixel is
// the reduction axis). 4 warps, each 32 x 32 of the tile.
//
// What bounds it, on an H100 SXM: 21.1 GFLOP (0.021 ms at 989 TFLOP/s)
// against 74.2 MB (37.5 of x and 36.7 of dy, each read once; 0.022 ms at
// 3.35 TB/s): bytes, by a hair. Each tap's blocks re-read x and dy, 9x in
// all; the nine taps of one slice sit next to each other in the grid and
// run together, so the re-reads come from L2. The partial tiles (splits x
// 9 x C x Co fp32, ~8 MB at the spike's shape) are written and read once
// more by the reduce.
// Left for later: one block for all nine taps of a slice (x read once from
// L2), wgmma.

#include "conv_fwd.cuh"

namespace {

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

template <bool VEC>
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
      if constexpr (VEC) {
        const bool x_ok = row_ok && c0 + v < a.C;
        const bool d_ok = row_ok && o0 + v < a.Co;
        cp_async16(xs + r * DW_LD + v, x_ok ? xsrc : a.x, x_ok ? 16 : 0);
        cp_async16(ds + r * DW_LD + v, d_ok ? dsrc : a.dy, d_ok ? 16 : 0);
      } else {
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
    }
    cp_async_commit();
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
    if (s + 1 < nsteps) {
      load(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
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
        const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
        if constexpr (VEC) {
          if (o < a.Co) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (o < a.Co) p[0] = v0;
          if (o + 1 < a.Co) p[1] = v1;
        }
      }
    }
}

// out[i] = part[0][i] + part[1][i] + ... in index order
__global__ void conv_reduce_kernel(const float* __restrict__ part,
                                   int n_parts, long long total,
                                   float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * total + i];
  out[i] = s;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// ptrs (host array): x (N, Hp, Wp, C) bf16, k (KH, KW, C, Co) bf16, out
// (N, Hp - KH + 1, Wp - KW + 1, Co). dims: N, Hp, Wp, C, Co, KH. KH = 3
// (a 3x3 kernel) writes fp32, KH = 2 (a 2x2 kernel) bf16. Launches on
// ``stream`` and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int crnerf_conv_fwd(const void* const* ptrs, int n_ptrs,
                               const int* dims, int n_dims, void* stream) {
  if (n_ptrs != 3 || n_dims != 6) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  ConvArgs a = {};
  a.N = dims[0]; a.Hp = dims[1]; a.Wp = dims[2]; a.C = dims[3];
  a.Co = dims[4];
  const int kh = dims[5];
  if ((kh != 2 && kh != 3) || a.N < 1 || a.C < 1 || a.Co < 1 ||
      a.Hp < kh || a.Wp < kh)
    return (int)cudaErrorInvalidValue;
  a.H = a.Hp - kh + 1; a.W = a.Wp - kh + 1;
  const long long M = (long long)a.N * a.H * a.W;
  if (M + CV_BM > 2147483647LL || (a.Co + CV_BN - 1) / CV_BN > 65535)
    return (int)cudaErrorInvalidValue;
  a.x = (const __nv_bfloat16*)ptrs[0];
  a.k = (const __nv_bfloat16*)ptrs[1];
  a.out = const_cast<void*>(ptrs[2]);
  const bool vec = a.C % 8 == 0 && a.Co % 8 == 0 && aligned16(a.x) &&
                   aligned16(a.k) && aligned16(a.out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kh == 3) return launch_conv_fwd<3, 3, float>(a, vec, st);
  return launch_conv_fwd<2, 2, __nv_bfloat16>(a, vec, st);
}

// ptrs (host array): x (N, Hp, Wp, C) bf16, dy (Hp - 2, Wp - 2 pixels, Co)
// bf16, part (splits x 9*C*Co) fp32 scratch, out (3, 3, C, Co) fp32.
// dims: N, Hp, Wp, C, Co, splits, m_per. Launches the weight-gradient
// kernel on (9 * C-tiles * Co-tiles, splits) blocks, block (., s) over
// pixels [s * m_per, (s + 1) * m_per), then the fixed-order sum of the
// splits into out. Returns cudaGetLastError() (or cudaErrorInvalidValue).
extern "C" int crnerf_conv_dw(const void* const* ptrs, int n_ptrs,
                              const int* dims, int n_dims, void* stream) {
  if (n_ptrs != 4 || n_dims != 7) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ptrs; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  DwArgs a = {};
  a.N = dims[0]; a.Hp = dims[1]; a.Wp = dims[2]; a.C = dims[3];
  a.Co = dims[4];
  const int splits = dims[5];
  a.m_per = dims[6];
  if (a.N < 1 || a.C < 1 || a.Co < 1 || a.Hp < 3 || a.Wp < 3 ||
      splits < 1 || splits > 65535 || a.m_per < 1)
    return (int)cudaErrorInvalidValue;
  a.H = a.Hp - 2; a.W = a.Wp - 2;
  const long long M = (long long)a.N * a.H * a.W;
  if (M > 2147483647LL - DW_PT || (long long)a.m_per * splits < M ||
      (long long)a.m_per * (splits - 1) >= M)
    return (int)cudaErrorInvalidValue;
  a.ctiles = (a.C + DW_T - 1) / DW_T;
  a.otiles = (a.Co + DW_T - 1) / DW_T;
  a.x = (const __nv_bfloat16*)ptrs[0];
  a.dy = (const __nv_bfloat16*)ptrs[1];
  a.part = (float*)ptrs[2];
  float* out = (float*)ptrs[3];
  const bool vec = a.C % 8 == 0 && a.Co % 8 == 0 && aligned16(a.x) &&
                   aligned16(a.dy) && aligned16(a.part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(9 * a.ctiles * a.otiles, splits);
  if (vec)
    conv_dw_kernel<true><<<grid, DW_THREADS, 0, st>>>(a);
  else
    conv_dw_kernel<false><<<grid, DW_THREADS, 0, st>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = 9LL * a.C * a.Co;
  conv_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.part, splits, total, out);
  return (int)cudaGetLastError();
}
