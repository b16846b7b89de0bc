// The per-point fused MLP forward on Hopper: the same function as
// mlp_fwd_kernel (fused_mlp_fwd.cuh, inference, bf16), with its products on
// wgmma and its weights streamed by TMA.
//
// Replaces crnerf_tpu/ops/fused_mlp.py:_make_fwd_kernel (the Pallas TPU
// kernel behind fused_mlp_apply and the forward of make_fused_mlp_train)
// for the bf16 shape that mlp_variant (ops/fused_mlp.py) gives to this
// kernel, the served MLPs': WP = 256, HP = 128, CP = 64, KE <= 128, a
// direction encode of at most 64 columns. The widths are template
// parameters; two instances are built: the inference forward, which is
// also route C's training forward where the wgmma backward takes the shape
// (mlp_bwd_variant), and the stash forward (STASH), which that backward
// (fused_mlp_bwd.cu) runs slab by slab. Included by fused_mlp_fwd.cu and
// fused_mlp_bwd.cu; fp32 and other widths stay on the mma.sync kernel.
//
// What bounds it: ~1.2 MFLOP of products a point at 8x256 against 12 bytes
// read and 4 (C + 1) written a point (260 at C = 64; 1.09 GB at 8192 x 512,
// ~0.33 ms of device memory against 5.2 ms of products at peak): the
// tensor cores. The mma.sync kernel reached 18% of that for the reason K1's
// did (fused_render_fwd_wgmma.cuh): every warp read its weight fragments
// from L2 for 32 rows, 32 FLOP a byte loaded. Design, as K1's wgmma
// forward, over the tile helpers it shares with it (wgmma_tile.cuh: the
// ring, the product loop, the encode, the trunk, the producer's trunk
// program):
//   * A persistent grid, one CTA an SM, walks work items: tiles of 128
//     consecutive POINTS, whatever ray they belong to, warpgroup g taking
//     rows 64 g .. 64 g + 63. Rows past M repeat the last point and are not
//     stored; M, S and dir_rep need be multiples of nothing. Nothing is
//     carried from tile to tile.
//   * Warpgroup 2 is the producer: one lane streams a tile's weight
//     program (ops/fused_render.py _stream_index, form "mlp": the trunk,
//     the final layer, the dir layer's hidden rows and its dir-encode rows
//     as one more slice, the feature head) by TMA bulk copies into an
//     mbarrier ring; setmaxnreg 40 / 232.
//   * The encode from one coordinate a point (the xyz-in form of K1). The
//     direction of row p is dirs[(p_base + p) / dir_rep]; its encode (the
//     wrapper's dir block, DK <= 64 columns at the compute dtype) is
//     gathered into one more 64-column A slice, zero past DK, and the dir
//     layer is one product over [hf | dir encode] @ [W_dh ; W_de] into one
//     accumulator: the TPU kernel's mm(hf, wd_h) + mm(enc, wd_e) per point
//     (K1 adds a once-per-ray SIMT dir term instead, which cannot serve a
//     direction a point). One slice of ~43.
//   * The sigma head in fp32 on the unrounded fp32 sigma row, SIMT over
//     the warpgroup's 64 rows in a fixed order (warp w its 16 rows, lane l
//     the columns l, l + 32, .., a shuffle tree: the mma.sync kernel's
//     order), in place of K1's bf16 64 x 8 product. Softplus fp32.
//   * The feature head's epilogue, sigmoid(dd @ W_c + b_c) in fp32, is
//     staged in the warpgroup's activation buffer (free once the product
//     has retired) and written out as the warpgroup's nrows * C
//     consecutive floats of the (M, C) output, neighbouring threads on
//     neighbouring addresses; sigma likewise.
//   * The stash (STASH): the instance with the stash adds stores and
//     nothing else, so its masks are the inference instance's bits. Every
//     buffer a product reads (the encode, each trunk layer's ReLU output,
//     hf, dd, the dir encode) is, once its epilogue is done, the image of
//     64-column x 64-row boxes of the stash rows [h_0 .. h_{L-1} | hf | dd
//     | encode | dir encode] (ops/fused_mlp.py mlp_grad_layout); one lane a
//     warpgroup stores it by TMA while the next product runs, through two
//     tensor maps over the points: one over each row's columns up to the
//     dir encode (the encode's 128-column buffer is clipped to its KE
//     columns there) and one over the whole row (the dir encode's slice,
//     clipped at the row's end to its DKP columns). Rows past M are not
//     stored. The lane waits for the stores to have read a buffer
//     (bulk_wait_read) before an epilogue writes it again.
//   * Dtype policy as mlp_fwd_kernel's: ReLU outputs, hf and dd rounded to
//     bf16; the sigma head fp32 on unrounded weights; biases, softplus and
//     sigmoid fp32. Sums run in another order than the mma.sync kernel's,
//     so the two agree to KERNEL_TOL, not to the bit.

#pragma once

#include "fused_mlp_fwd.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int MW_TILE = 2 * WG_ROWS;   // points a work item
constexpr int MW_DIR_K = 64;           // dir-encode columns: one A slice
constexpr int MW_FLOATS = 4 * WG_ROWS; // a warpgroup's sigma (64), xyz (192)

// bytes but the weight ring: 1024 to align, the barriers, both
// warpgroups' encode, dir-encode and activation buffers, their floats
template <int WP>
__host__ __device__ constexpr int mw_fixed_bytes() {
  return 1024 + 1024 + 2 * (KEW / 64 + 1 + WP / 64) * A_SLICE +
         2 * MW_FLOATS * 4;
}

template <int WP>
__host__ __device__ constexpr int mw_ring_slots() {
  constexpr int n = (WG_SMEM_MAX - mw_fixed_bytes<WP>()) / (WP * 128);
  return n < WG_MAX_NS ? n : WG_MAX_NS;
}

template <int WP>
__host__ __device__ constexpr int mw_smem_bytes() {
  return mw_fixed_bytes<WP>() + mw_ring_slots<WP>() * WP * 128;
}

// ------------------------------------------------------------- kernel
// STASH: smap (the stash's columns up to the dir encode) and dmap (its
// whole rows), ray_rows_map over the M points, take the stores.
template <int WP, int HP, int CP, bool STASH>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mlp_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap smap,
                         const __grid_constant__ CUtensorMap dmap,
                         const MArgs a, const uint8_t* __restrict__ wpack) {
  constexpr int SLOT = WP * 128;
  constexpr int NS = mw_ring_slots<WP>();
  constexpr int LDF = CP + 4;          // a staged feature row, floats
  static_assert(NS >= 2, "no room for the weight ring");
  static_assert(WP % 64 == 0 && HP % 64 == 0 && CP % 64 == 0 && WP <= 256,
                "widths");
  static_assert(WG_ROWS * LDF * 4 <= (WP / 64) * A_SLICE,
                "the features are staged in the activation buffer");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // barriers, the weight ring, both warpgroups' encode, dir-encode and
  // activation buffers (all on 1024-byte boundaries), then the floats
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WG_MAX_NS;
  uint8_t* ring = smem + 1024;
  uint8_t* encb = ring + NS * SLOT;
  uint8_t* dencb = encb + 2 * (KEW / 64) * A_SLICE;
  uint8_t* actb = dencb + 2 * A_SLICE;
  float* fl = reinterpret_cast<float*>(actb + 2 * (WP / 64) * A_SLICE);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int items = (a.M + MW_TILE - 1) / MW_TILE;

  if (tid >= 256) {  // ----------------------------------------- producer
    setmaxnreg_dec<WG_REGS_PRODUCER>();
    if (tid != 256) return;
    Ring rg;
    auto put = [&](const uint8_t* src, uint32_t bytes) {
      mbar_wait(&empty[rg.s], rg.ph ^ 1);
      mbar_expect_tx(&full[rg.s], bytes);
      bulk_load(ring + rg.s * SLOT, src, bytes, &full[rg.s]);
      rg.next<NS>();
    };
#pragma unroll 1
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const uint8_t* p = wg_put_trunk<WP, SLOT>(wpack, a.L, a.skip_mask, put);
#pragma unroll 1
      for (int k = 0; k < WP / 64; ++k, p += WP * 128) put(p, WP * 128);
      // the dir layer: its hidden rows, then its dir-encode rows
#pragma unroll 1
      for (int k = 0; k < WP / 64 + 1; ++k, p += HP * 128) put(p, HP * 128);
#pragma unroll 1
      for (int k = 0; k < HP / 64; ++k, p += CP * 128) put(p, CP * 128);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<WG_REGS_CONSUMER>();
  const int g = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const bool leader = wtid == 0;
  const int wg_bar = 2 + g;  // named barrier of this warpgroup
  auto wg_sync = [&]() { named_bar_sync(wg_bar, 128); };

  uint8_t* enc = encb + g * (KEW / 64) * A_SLICE;
  uint8_t* denc = dencb + g * A_SLICE;
  uint8_t* act = actb + g * (WP / 64) * A_SLICE;
  const uint32_t enc_a = smem_u32(enc), denc_a = smem_u32(denc);
  const uint32_t act_a = smem_u32(act), ring_a = smem_u32(ring);
  float* sig = fl + g * MW_FLOATS;
  float* xyz = sig + WG_ROWS;          // 64 x 3
  float* stage = reinterpret_cast<float*>(act);   // 64 x LDF

  // the accumulator fragment: rows r0 and r0 + 8, columns 8 nb + cq (+1)
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  // the stash row's columns: h_i at i WP, then hf, dd, the encode, the
  // dir encode
  const int o_hf = a.L * WP, o_dd = o_hf + WP, o_enc = o_dd + HP;

  Ring rg;
  float acc[WP / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int pb = item * MW_TILE + g * WG_ROWS;   // row 0's point
    const int nrows = max(0, min(WG_ROWS, a.M - pb));
    // STASH: nslices 64-column slices of buf into the stash columns col..
    // of this warpgroup's rows (clipped at M and at the map's columns)
    auto stash_store = [&](const CUtensorMap* map, const uint8_t* buf,
                           int nslices, int col) {
      if constexpr (STASH) {
        if (leader && nrows > 0) {
          for (int k = 0; k < nslices; ++k)
            tma_store_3d(map, buf + k * A_SLICE, col + 64 * k, pb, 0);
          bulk_commit();
        }
      }
    };
    // before a buffer those stores read is written again (the leader
    // waits, a warpgroup barrier follows)
    auto stash_wait = [&]() {
      if constexpr (STASH) {
        if (leader) bulk_wait_read();
      }
    };
    if constexpr (STASH) {   // the last item's stores have read enc, denc
      stash_wait();
      wg_sync();
    }
    // the points (rows past M repeat the last one) and their dir encode
    for (int i = wtid; i < WG_ROWS * 3; i += 128) {
      const int r = i / 3, c = i % 3;
      const float x = a.xyz[(size_t)min(pb + r, a.M - 1) * 3 + c];
      xyz[i] = x;
      st_bf16(enc, r, c, x);
    }
    for (int i = wtid; i < WG_ROWS * (MW_DIR_K / 2); i += 128) {
      const int r = i / (MW_DIR_K / 2), e = 2 * (i % (MW_DIR_K / 2));
      const int dir = (a.p_base + min(pb + r, a.M - 1)) / a.R;
      const float* db = a.dirb + (size_t)dir * a.DK;
      st_bf16x2(denc, r, e, e < a.DK ? db[e] : 0.f,
                e + 1 < a.DK ? db[e + 1] : 0.f);
    }
    wg_encode_pad(enc, a.F, wtid);
    wg_sync();
    wg_encode_sincos(enc, xyz, a.F, a.exact, wtid);
    fence_proxy_async();
    wg_sync();
    stash_store(&smap, enc, KEW / 64, o_enc);
    stash_store(&dmap, denc, 1, o_enc + a.KE);

    // ---- trunk: h_i = relu([enc |] h_{i-1} @ W_i + b_i), in place
    wg_trunk<WP, NS, SLOT>(
        a, acc, enc_a, act_a, act, ring_a, full, empty, rg, leader, r0, cq,
        wg_sync, stash_wait,
        [&](int i) { stash_store(&smap, act, WP / 64, i * WP); });

    // ---- sigma head in fp32 on the unrounded sigma row
    wg_sigma_rows<WP>(act, a.wsrow, a.bs[0], sig, warp, lane);

    // ---- xyz_encoding_final: hf = h @ W_f + b_f, in place (after every
    // warp's sigma rows have read h)
    zero_acc(acc);
    wg_product<WP, NS, SLOT>(
        acc, WP / 64, [&](int kc) { return act_a + kc * A_SLICE; }, ring_a,
        full, empty, rg, leader);
    stash_wait();
    wg_sync();
#pragma unroll
    for (int nb = 0; nb < WP / 8; ++nb) {
      const int c = nb * 8 + cq;
      const float b0 = a.bf[c], b1 = a.bf[c + 1];
      st_bf16x2(act, r0, c, acc[nb * 4] + b0, acc[nb * 4 + 1] + b1);
      st_bf16x2(act, r0 + 8, c, acc[nb * 4 + 2] + b0, acc[nb * 4 + 3] + b1);
    }
    fence_proxy_async();
    wg_sync();
    stash_store(&smap, act, WP / 64, o_hf);

    // ---- dir layer: dd = relu([hf | dir encode] @ [W_dh ; W_de] + b_d),
    // in place
    {
      float acc_d[HP / 2];
      zero_acc(acc_d);
      wg_product<HP, NS, SLOT>(
          acc_d, WP / 64 + 1,
          [&](int kc) {
            return kc < WP / 64 ? act_a + kc * A_SLICE : denc_a;
          },
          ring_a, full, empty, rg, leader);
      stash_wait();
      wg_sync();
#pragma unroll
      for (int nb = 0; nb < HP / 8; ++nb) {
        const int c = nb * 8 + cq;
        const float b0 = a.bd[c], b1 = a.bd[c + 1];
        st_bf16x2(act, r0, c, fmaxf(acc_d[nb * 4] + b0, 0.f),
                  fmaxf(acc_d[nb * 4 + 1] + b1, 0.f));
        st_bf16x2(act, r0 + 8, c, fmaxf(acc_d[nb * 4 + 2] + b0, 0.f),
                  fmaxf(acc_d[nb * 4 + 3] + b1, 0.f));
      }
    }
    fence_proxy_async();
    wg_sync();
    stash_store(&smap, act, HP / 64, o_dd);

    // ---- feature head: sigmoid(dd @ W_c + b_c), fp32, staged over dd
    {
      float acc_c[CP / 2];
      zero_acc(acc_c);
      wg_product<CP, NS, SLOT>(
          acc_c, HP / 64, [&](int kc) { return act_a + kc * A_SLICE; },
          ring_a, full, empty, rg, leader);
      stash_wait();
      wg_sync();
#pragma unroll
      for (int nb = 0; nb < CP / 8; ++nb) {
        const int c = nb * 8 + cq;
        const float b0 = a.bc[c], b1 = a.bc[c + 1];
        *reinterpret_cast<float2*>(stage + r0 * LDF + c) =
            make_float2(sigmoidf(acc_c[nb * 4] + b0),
                        sigmoidf(acc_c[nb * 4 + 1] + b1));
        *reinterpret_cast<float2*>(stage + (r0 + 8) * LDF + c) =
            make_float2(sigmoidf(acc_c[nb * 4 + 2] + b0),
                        sigmoidf(acc_c[nb * 4 + 3] + b1));
      }
    }
    wg_sync();
    // ---- the warpgroup's rows of the outputs: nrows * C consecutive
    // floats of the features, nrows of sigma
    if (a.feat != nullptr) {
      float* fo = a.feat + (size_t)pb * a.C;
      for (int i = wtid; i < nrows * a.C; i += 128)
        fo[i] = stage[(i / a.C) * LDF + i % a.C];
    }
    if (a.sig != nullptr && wtid < nrows)
      a.sig[pb + wtid] = softplusf(sig[wtid]);
  }
  if constexpr (STASH) {
    if (leader) bulk_wait();
  }
}

// Launches mlp_fwd_wgmma_kernel<WP, HP, CP, STASH> on ``st`` over
// min(tiles of 128 points, SMs) CTAs; cudaGetLastError().
template <int WP, int HP, int CP, bool STASH>
int launch_mlp_wgmma(const CUtensorMap& smap, const CUtensorMap& dmap,
                     const MArgs& a, const void* wpack, cudaStream_t st) {
  constexpr int smem = mw_smem_bytes<WP>();
  static_assert(smem <= WG_SMEM_MAX, "shared memory");
  auto kern = mlp_fwd_wgmma_kernel<WP, HP, CP, STASH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int items = (a.M + MW_TILE - 1) / MW_TILE;
  const int grid = items < sms ? items : sms;
  kern<<<grid, WG_THREADS, smem, st>>>(smap, dmap, a,
                                       static_cast<const uint8_t*>(wpack));
  return (int)cudaGetLastError();
}

// Arguments as parse_mlp_args takes them, and after them the weight stream
// (wgmma_mlp_weights in ops/fused_mlp.py). Only the shape this kernel
// takes: bf16, (WP, HP, CP) = (256, 128, 64), KE <= 128, DK <= 64; with or
// without the stash (its row 16-byte aligned). Returns cudaGetLastError(),
// a CUresult of the stash's tensor maps, or cudaErrorInvalidValue.
int mlp_fwd_wgmma_entry(const void* const* ptrs, int n_ptrs, const int* dims,
                        int n_dims, void* stream) {
  if (n_ptrs < 1) return (int)cudaErrorInvalidValue;
  MArgs a;
  bool bf16;
  int rc = parse_mlp_args(ptrs, n_ptrs - 1, dims, n_dims, a, bf16);
  if (rc != 0) return rc;
  const void* wpack = ptrs[n_ptrs - 1];
  if (!bf16 || !wpack || ((uintptr_t)wpack & 15) || a.KE > KEW ||
      3 + 6 * a.F > KEW || a.DK > MW_DIR_K || a.DKP > MW_DIR_K ||
      a.WP != 256 || a.HP != 128 || a.CP != 64 ||
      (a.stash && (((uintptr_t)a.stash & 15) || a.SC % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap smap = {}, dmap = {};
  if (!a.stash)
    return launch_mlp_wgmma<256, 128, 64, false>(smap, dmap, a, wpack, st);
  rc = ray_rows_map(&smap, a.stash, 1, a.M, a.SC - a.DKP, a.SC);
  if (!rc) rc = ray_rows_map(&dmap, a.stash, 1, a.M, a.SC);
  if (rc) return rc;
  return launch_mlp_wgmma<256, 128, 64, true>(smap, dmap, a, wpack, st);
}

}  // namespace
