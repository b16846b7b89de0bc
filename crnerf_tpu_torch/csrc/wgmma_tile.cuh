// What the fused render's wgmma kernels share (fused_render_fwd_wgmma.cuh,
// the forward; fused_render_bwd_wgmma.cuh, the backward's dz chain): a
// persistent CTA of two consumer warpgroups, 64 rows each, and a producer
// warpgroup whose one lane streams every product's B operand, pre-packed on
// the host as 64-deep K-slices (ops/fused_render.py pack_wgmma_b), through
// an mbarrier ring of weight slots; the warpgroup's activation buffers as
// 128-byte-swizzled, K-major 64-column slices of 64 rows, which are at once
// wgmma's A operand and the image of a SWIZZLE_128B tensor-map box; and the
// product loop over the ring.

#pragma once

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

}  // namespace
