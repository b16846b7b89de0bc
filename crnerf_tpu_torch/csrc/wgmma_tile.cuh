// What the wgmma kernels of the NeRF MLP share (fused_render_fwd_wgmma.cuh,
// the fused render's forward; fused_render_bwd_wgmma.cuh, its backward's dz
// chain; fused_mlp_fwd_wgmma.cuh, the per-point forward): a persistent CTA
// of two consumer warpgroups, 64 rows each, and a producer warpgroup whose
// one lane streams every product's B operand, pre-packed on the host as
// 64-deep K-slices (ops/fused_render.py pack_wgmma_b), through an mbarrier
// ring of weight slots; the warpgroup's activation buffers as
// 128-byte-swizzled, K-major 64-column slices of 64 rows, which are at once
// wgmma's A operand and the image of a SWIZZLE_128B tensor-map box; the
// product loop over the ring; and what the two forwards share: the encode
// of a warpgroup's rows, the trunk, and the producer's program for it.

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

template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 8)
    wgmma_m64n8k16<0, 0>(d, da, db);
  else if constexpr (N == 64)
    wgmma_m64n64k16<0, 0>(d, da, db);
  else if constexpr (N == 128)
    wgmma_m64n128k16<0, 0>(d, da, db);
  else
    wgmma_m64n256k16<0, 0>(d, da, db);
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
// address of a 64-row swizzled slice), B the next ring slot. One product
// group a slice; a slot is released (one arrival of this warpgroup) once
// the group after it has been committed and it has retired.
template <int N, int NS, int SLOT, class AAddr>
__device__ __forceinline__ void wg_product(float (&acc)[N / 2], int nk,
                                           AAddr a_addr, uint32_t ring_a,
                                           uint64_t* full, uint64_t* empty,
                                           Ring& ring, bool leader) {
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(&full[ring.s], ring.ph);
    const uint32_t aa = a_addr(kc);
    const uint32_t bb = ring_a + ring.s * SLOT;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_mma<N>(acc, sw128_desc(aa + kk * 32, 16, 1024),
                sw128_desc(bb + kk * 32, 16, 1024));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (leader && prev >= 0) mbar_arrive(&empty[prev]);
    prev = ring.s;
    ring.next<NS>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader && prev >= 0) mbar_arrive(&empty[prev]);
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
// reach the next ray. Returns 0 or a CUresult.
int ray_rows_map(CUtensorMap* map, const void* base, int n, int s,
                 int cols) {
  const long long dims[3] = {cols, s, n};
  const int box[3] = {64, WG_ROWS, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, 3, dims,
                    box);
}

// ------------------------------------------------ what the forwards share
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
// visible to the async proxy (the stash forward stores them from there).
// Args: the kernel's arguments (L, skip_mask, b).
template <int WP, int NS, int SLOT, class Args, class Sync, class Before,
          class After>
__device__ __forceinline__ void wg_trunk(const Args& a, float (&acc)[WP / 2],
                                         uint32_t enc_a, uint32_t act_a,
                                         uint8_t* act, uint32_t ring_a,
                                         uint64_t* full, uint64_t* empty,
                                         Ring& rg, bool leader, int r0,
                                         int cq, Sync wg_sync,
                                         Before before_epi,
                                         After after_epi) {
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
        ring_a, full, empty, rg, leader);
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
    const bool with_enc = i == 0 || ((skip_mask >> i) & 1);
    const int nk = (with_enc ? KEW / 64 : 0) + (i > 0 ? WP / 64 : 0);
    for (int k = 0; k < nk; ++k, p += SLOT) put(p, SLOT);
  }
  return p;
}

}  // namespace
