// What the wgmma kernels of the NeRF MLP share (fused_render_fwd_wgmma.cuh,
// the fused render's forward; fused_render_bwd_wgmma.cuh, its backward's dz
// chain; fused_mlp_fwd_wgmma.cuh, the per-point forward;
// fused_mlp_bwd_wgmma.cuh, the per-point backward's dz chain): a persistent
// CTA of two consumer warpgroups, 64 rows each, and a producer warpgroup
// whose one lane streams every product's B operand, pre-packed on the host
// as 64-deep K-slices (ops/fused_render.py pack_wgmma_b), through an
// mbarrier ring of weight slots; the warpgroup's activation buffers as
// 128-byte-swizzled, K-major 64-column slices of 64 rows, which are at once
// wgmma's A operand and the image of a SWIZZLE_128B tensor-map box; the
// product loop over the ring; what the forwards share: the encode of a
// warpgroup's rows, the trunk, and the producer's program for it; what the
// per-point kernels share: the fp32 sigma head; and what the two chains
// share: the layout of their weight stream, its producer, the masked dz
// epilogue with its fixed-order column sums, and the walk down the trunk.

#pragma once

#include "fused_render_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;            // rows a consumer warpgroup owns
constexpr int WG_THREADS = 384;        // two consumer warpgroups + producer
constexpr int WG_REGS_PRODUCER = 40;   // registers a thread after setmaxnreg
constexpr int WG_REGS_CONSUMER = 232;
constexpr int A_SLICE = WG_ROWS * 128; // 64 rows x 64 bf16, swizzled
constexpr int SIG_N = 8;               // the sigma head's product width
constexpr int WG_SMEM_MAX = 232448;    // the H100's 227 KB a block
constexpr int WG_MAX_NS = 8;
constexpr int KEW = 128;               // encode columns in this layout

// one m64nNk16 product; T: both operands K-major (0) or MN-major (1)
template <int N, int T = 0>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 8)
    wgmma_m64n8k16<T, T>(d, da, db);
  else if constexpr (N == 64)
    wgmma_m64n64k16<T, T>(d, da, db);
  else if constexpr (N == 128)
    wgmma_m64n128k16<T, T>(d, da, db);
  else
    wgmma_m64n256k16<T, T>(d, da, db);
}

// Byte offset of element (r, k) in a warpgroup's K-major, 128-byte
// swizzled buffer: 64-column slices of 64 rows x 128 bytes, the 16-byte
// chunk q of row r at q ^ (r % 8).
__device__ __forceinline__ int sw_off(int r, int k) {
  return (k >> 6) * A_SLICE + r * 128 +
         ((((k & 63) >> 3) ^ (r & 7)) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ void st_bf16(uint8_t* buf, int r, int k,
                                        float v) {
  *reinterpret_cast<__nv_bfloat16*>(buf + sw_off(r, k)) =
      __float2bfloat16_rn(v);
}

__device__ __forceinline__ void st_bf16x2(uint8_t* buf, int r, int k,
                                          float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(buf + sw_off(r, k)) =
      __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ __nv_bfloat162 ld_bf16x2(const uint8_t* buf,
                                                    int r, int k) {
  return *reinterpret_cast<const __nv_bfloat162*>(buf + sw_off(r, k));
}

// The ring both sides walk in the same order: slot and phase.
struct Ring {
  int s = 0, ph = 0;
  template <int NS>
  __device__ __forceinline__ void next() {
    if (++s == NS) { s = 0; ph ^= 1; }
  }
};

// acc += A @ B over nk K-slices of 64: slice kc's A at a_addr(kc) (shared
// address of a 64-row swizzled slice, read once the slot is full), B at
// ring_a + SLOT * (the next ring slot). One product group a slice; a slot
// is released (one arrival of this warpgroup) once the group after it has
// been committed and it has retired (``release``: its arrival, on this
// CTA's barrier, or also on a cluster peer's that loads into this slot).
// issued() runs once the last group is committed, before it retires.
// MN_LBO = 0: both operands K-major
// (the K-slice along the 128-byte row); else both MN-major, the rows of a
// box its 64 K-steps and its 64-wide M or N chunks MN_LBO bytes apart (a
// TMA box of 64 rows as it lies).
struct LocalRelease {
  __device__ __forceinline__ void operator()(uint64_t* bar) const {
    mbar_arrive(bar);
  }
};

struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

template <int N, int NS, int SLOT, int MN_LBO = 0, class AAddr,
          class Release = LocalRelease, class Issued = NoHook>
__device__ __forceinline__ void wg_product(float (&acc)[N / 2], int nk,
                                           AAddr a_addr, uint32_t ring_a,
                                           uint64_t* full, uint64_t* empty,
                                           Ring& ring, bool leader,
                                           Release release = {},
                                           Issued issued = {}) {
  constexpr uint32_t KSTEP = MN_LBO ? 16 * 128 : 32;
  constexpr uint32_t LBO = MN_LBO ? MN_LBO : 16;
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&full[ring.s], ring.ph);
    const uint32_t aa = a_addr(kc);
    const uint32_t bb = ring_a + ring.s * SLOT;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_mma<N, MN_LBO ? 1 : 0>(acc, sw128_desc(aa + kk * KSTEP, LBO, 1024),
                                sw128_desc(bb + kk * KSTEP, LBO, 1024));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (leader && prev >= 0) release(&empty[prev]);
    prev = ring.s;
    ring.next<NS>();
  }
  issued();
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader && prev >= 0) release(&empty[prev]);
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// A row-major bf16 matrix of n rays x s points x cols columns as a 3-D
// tensor map with 64-column x 64-row boxes of one ray, 128-byte swizzle:
// a box is one A_SLICE; rows past s and columns past cols are zero-filled
// on a load and not written on a store, so a warpgroup's 64 rows never
// reach the next ray. ``ld``: the row's length in elements where it is
// longer than ``cols`` (the map then covers each row's first cols
// columns); 0: cols. The per-point kernels take n = 1 and s points.
// Returns 0 or a CUresult.
int ray_rows_map(CUtensorMap* map, const void* base, int n, int s, int cols,
                 int ld = 0) {
  const long long row = 2LL * (ld > 0 ? ld : cols);
  const long long dims[3] = {cols, s, n};
  const long long strides[2] = {row, row * s};
  const int box[3] = {64, WG_ROWS, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, 3, dims,
                    box, strides);
}

// ------------------------------------------------ what the forwards share
// K-slices of 64 of trunk layer i's product: the encode's KEW / 64 where
// the layer takes the encode (layer 0, the skips), then the hidden rows'
// WP / 64 (every layer but 0).
template <int WP>
__device__ __forceinline__ int wg_layer_slices(int i, int skip_mask) {
  const bool with_enc = i == 0 || ((skip_mask >> i) & 1);
  return (with_enc ? KEW / 64 : 0) + (i > 0 ? WP / 64 : 0);
}

// The encode's columns past the point: zero from 3 + 6F to KEW. The caller
// stores x, y, z into columns 0..2 and into xyz[64 x 3]; a warpgroup
// barrier lies between those stores and wg_encode_sincos.
__device__ __forceinline__ void wg_encode_pad(uint8_t* enc, int F,
                                              int wtid) {
  const int w0 = KEW - 3 - 6 * F;
  for (int i = wtid; i < WG_ROWS * w0; i += 128)
    st_bf16(enc, i / w0, 3 + 6 * F + i % w0, 0.f);
}

// [sin 2^k x, cos 2^k x] of every row's point into columns 3 .. 3 + 6F:
// sinf / cosf of every octave (exact), or the anchored double-angle
// recurrence, exact sin / cos every ANCHOR_SPAN octaves.
__device__ __forceinline__ void wg_encode_sincos(uint8_t* enc,
                                                 const float* xyz, int F,
                                                 int exact, int wtid) {
  if (exact) {
    for (int i = wtid; i < WG_ROWS * 3 * F; i += 128) {
      const int r = i / (3 * F), rem = i % (3 * F), k = rem / 3,
                c = rem % 3;
      const float arg = __fmul_rn(xyz[r * 3 + c], pow2f(k));
      st_bf16(enc, r, 3 + 6 * k + c, sinf(arg));
      st_bf16(enc, r, 6 + 6 * k + c, cosf(arg));
    }
  } else {
    const int n_anchor = (F + ANCHOR_SPAN - 1) / ANCHOR_SPAN;
    for (int i = wtid; i < WG_ROWS * 3 * n_anchor; i += 128) {
      const int r = i / (3 * n_anchor), rem = i % (3 * n_anchor);
      const int a0 = (rem / 3) * ANCHOR_SPAN, c = rem % 3;
      const float va = __fmul_rn(xyz[r * 3 + c], pow2f(a0));
      float s = sinf(va), co = cosf(va);
      const int k_end = min(a0 + ANCHOR_SPAN, F);
      for (int k = a0; k < k_end; ++k) {
        if (k > a0) {
          const float two_s = __fmul_rn(2.f, s);
          const float s2 = __fmul_rn(two_s, co);
          co = __fsub_rn(1.f, __fmul_rn(two_s, s));
          s = s2;
        }
        st_bf16(enc, r, 3 + 6 * k + c, s);
        st_bf16(enc, r, 6 + 6 * k + c, co);
      }
    }
  }
}

// The trunk on a warpgroup's 64 rows: h_i = relu([enc |] h_{i-1} @ W_i +
// b_i) for i < a.L, each layer's products over the ring into acc, its
// epilogue (bias, ReLU, bf16) into act in place. before_epi() runs once
// the layer's products have retired, before the warpgroup barrier that
// precedes the epilogue; after_epi(i) once layer i's rows are written and
// visible to the async proxy (the stash forward stores them from there);
// issued() once the layer's last product group is committed.
// Args: the kernel's arguments (L, skip_mask, b).
template <int WP, int NS, int SLOT, class Args, class Sync, class Before,
          class After, class Issued = NoHook>
__device__ __forceinline__ void wg_trunk(const Args& a, float (&acc)[WP / 2],
                                         uint32_t enc_a, uint32_t act_a,
                                         uint8_t* act, uint32_t ring_a,
                                         uint64_t* full, uint64_t* empty,
                                         Ring& rg, bool leader, int r0,
                                         int cq, Sync wg_sync,
                                         Before before_epi,
                                         After after_epi,
                                         Issued issued = {}) {
  for (int i = 0; i < a.L; ++i) {
    const bool with_enc = i == 0 || ((a.skip_mask >> i) & 1);
    const int ne = with_enc ? KEW / 64 : 0;
    const int nk = ne + (i > 0 ? WP / 64 : 0);
    zero_acc(acc);
    wg_product<WP, NS, SLOT>(
        acc, nk,
        [&](int kc) {
          return kc < ne ? enc_a + kc * A_SLICE
                         : act_a + (kc - ne) * A_SLICE;
        },
        ring_a, full, empty, rg, leader, LocalRelease{}, issued);
    before_epi();
    wg_sync();
    const float* bias = a.b[i];
#pragma unroll
    for (int nb = 0; nb < WP / 8; ++nb) {
      const int c = nb * 8 + cq;
      const float b0 = bias[c], b1 = bias[c + 1];
      st_bf16x2(act, r0, c, fmaxf(acc[nb * 4] + b0, 0.f),
                fmaxf(acc[nb * 4 + 1] + b1, 0.f));
      st_bf16x2(act, r0 + 8, c, fmaxf(acc[nb * 4 + 2] + b0, 0.f),
                fmaxf(acc[nb * 4 + 3] + b1, 0.f));
    }
    fence_proxy_async();
    wg_sync();
    after_epi(i);
  }
}

// The producer's program for the trunk of one tile: every layer's K-slices
// (the encode's KEW / 64, then the hidden rows' WP / 64), in the order
// wg_trunk takes them, each a SLOT-byte slice of the stream from p on.
// Returns the stream's position after the trunk.
template <int WP, int SLOT, class Put>
__device__ __forceinline__ const uint8_t* wg_put_trunk(const uint8_t* p,
                                                       int L, int skip_mask,
                                                       Put put) {
  for (int i = 0; i < L; ++i) {
    const int nk = wg_layer_slices<WP>(i, skip_mask);
    for (int k = 0; k < nk; ++k, p += SLOT) put(p, SLOT);
  }
  return p;
}

// ------------------------------------------------ what the chains share
// Byte offsets in the chains' weight stream (ops/fused_render.py
// _stream_index, form "chain"): the sigma columns (WP / 64 slices of
// SIG_N x 64), the feature head as the forward takes it, then W^T of the
// feature head, the dir layer's hidden rows, the final layer and the trunk
// layers L-1 .. 1, in the order the chains take them.
template <int WP, int HP, int CP>
struct ChainStream {
  static constexpr uint32_t WC = (WP / 64) * SIG_N * 128;
  static constexpr uint32_t WCT = WC + (HP / 64) * CP * 128;
  static constexpr uint32_t WDHT = WCT + (CP / 64) * HP * 128;
  static constexpr uint32_t WFT = WDHT + (HP / 64) * WP * 128;
};

// The producer lane's copies: n slices of ``bytes`` each from byte ``off``
// of the stream into the ring; one copy site and no unrolling (the
// producer warpgroup has 40 registers a thread).
template <int NS, int SLOT>
__device__ __forceinline__ void wg_put_run(const uint8_t* wpack, uint32_t off,
                                           int n, uint32_t bytes,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, Ring& rg) {
#pragma unroll 1
  for (int k = 0; k < n; ++k, off += bytes) {
    mbar_wait(&empty[rg.s], rg.ph ^ 1);
    mbar_expect_tx(&full[rg.s], bytes);
    bulk_load(ring + rg.s * SLOT, wpack + off, bytes, &full[rg.s]);
    rg.next<NS>();
  }
}

// the four warps' column sums (rd, after a warpgroup barrier) onto dst, in
// warp order
__device__ __forceinline__ void add_colsums(const float* rd, int n,
                                            float* dst, int wtid) {
  for (int c = wtid; c < n; c += 128)
    dst[c] += (rd[c] + rd[n + c]) + (rd[2 * n + c] + rd[3 * n + c]);
}

// columns c, c + 1 summed over the warp's 16 rows (the thread's two rows
// in s0, s1) into rdw[c], rdw[c + 1]
__device__ __forceinline__ void warp_colsum(float s0, float s1, float* rdw,
                                            int c, int lane) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (lane < 4) {
    rdw[c] = s0;
    rdw[c + 1] = s1;
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The chains' epilogue of one N-wide product on a warpgroup's rows: each
// value of acc, plus ds_r * wtop[c] where wtop is given (the sigma branch
// of the final layer), zeroed where the mask buffer's entry is not > 0
// (with a mask buffer: a ReLU's output), rounded to bf16 into ``out`` as
// the next product's A, its unrounded fp32 value summed per column over
// the warp's rows into rdw (the caller adds the warps in order).
template <int N>
__device__ __forceinline__ void wg_dz_epilogue(const float (&acc)[N / 2],
                                               uint8_t* out,
                                               const uint8_t* mask,
                                               const float* wtop, float ds0,
                                               float ds1, float* rdw, int r0,
                                               int cq, int lane) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const int c = nb * 8 + cq;
    float v0 = acc[nb * 4], v1 = acc[nb * 4 + 1];
    float v2 = acc[nb * 4 + 2], v3 = acc[nb * 4 + 3];
    if (wtop != nullptr) {
      const float w0 = wtop[c], w1 = wtop[c + 1];
      v0 += ds0 * w0;
      v1 += ds0 * w1;
      v2 += ds1 * w0;
      v3 += ds1 * w1;
    }
    if (mask != nullptr) {
      const __nv_bfloat162 m0 = ld_bf16x2(mask, r0, c);
      const __nv_bfloat162 m1 = ld_bf16x2(mask, r0 + 8, c);
      v0 = __low2float(m0) > 0.f ? v0 : 0.f;
      v1 = __high2float(m0) > 0.f ? v1 : 0.f;
      v2 = __low2float(m1) > 0.f ? v2 : 0.f;
      v3 = __high2float(m1) > 0.f ? v3 : 0.f;
    }
    st_bf16x2(out, r0, c, v0, v1);
    st_bf16x2(out, r0 + 8, c, v2, v3);
    warp_colsum(v0 + v2, v1 + v3, rdw, c, lane);
  }
}

// The chains' walk down the trunk on a warpgroup's 64 rows, dz in abuf (the
// warpgroup's WP-column buffer, holding dhf on entry): dz_{L-1} = (h_{L-1} >
// 0) * (dhf @ W_f^T + ds_r w_sigma^T), then dz_i = (h_i > 0) * (dz_{i+1} @
// W_{i+1}^T) down to dz_0, each product over the ring, each epilogue
// (wg_dz_epilogue) masked by h_i in mbuf (h_{L-1} there on entry) and its
// column sums added in warp order onto bac + i WP. store_dz(i) stores dz_i
// from abuf while the next product runs (one lane, TMA); load_h(i) loads
// h_i into mbuf during that product and wait_h() waits for it.
template <int WP, int NS, int SLOT, class Sync, class WaitH, class LoadH,
          class Store>
__device__ __forceinline__ void wg_chain_trunk(
    int L, float (&acc)[WP / 2], uint8_t* abuf, uint32_t abuf_a,
    const uint8_t* mbuf, uint32_t ring_a, uint64_t* full, uint64_t* empty,
    Ring& rg, bool leader, int warp, int lane, int wtid, int r0, int cq,
    float* rd, float* bac, const float* wsig, float ds0, float ds1,
    Sync wg_sync, WaitH wait_h, LoadH load_h, Store store_dz) {
  for (int i = L - 1; i >= 0; --i) {
    const bool top = i == L - 1;
    zero_acc(acc);
    wg_product<WP, NS, SLOT>(
        acc, WP / 64, [&](int kc) { return abuf_a + kc * A_SLICE; }, ring_a,
        full, empty, rg, leader);
    if (leader) bulk_wait_read();
    if (!top) wait_h();   // h_i, loaded during the product
    wg_sync();
    wg_dz_epilogue<WP>(acc, abuf, mbuf, top ? wsig : nullptr, ds0, ds1,
                       rd + warp * WP, r0, cq, lane);
    fence_proxy_async();
    wg_sync();
    add_colsums(rd, WP, bac + i * WP, wtid);
    store_dz(i);
    if (i > 0 && leader) load_h(i - 1);   // for the next epilogue
  }
}

// ------------------------------------------ what the per-point kernels share
// The per-point MLP's sigma head in fp32 on the unrounded fp32 sigma row:
// z[r] = buf[r] . wsrow + bs for a warpgroup's 64 rows of the swizzled
// buffer buf (h_{L-1}), warp w its 16 rows, lane l the columns l, l + 32,
// .., a shuffle tree: the mma.sync kernel's order (fused_mlp_fwd.cuh
// rowdot_f32).
template <int WP>
__device__ __forceinline__ void wg_sigma_rows(const uint8_t* buf,
                                              const float* wsrow, float bs,
                                              float* z, int warp, int lane) {
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = lane; k < WP; k += 32)
      s += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
               buf + sw_off(r, k))) *
           __ldg(wsrow + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) z[r] = s + bs;
  }
}

}  // namespace
