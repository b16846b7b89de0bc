// The fused render forward on Hopper: the same function as
// render_fwd_kernel (fused_render_fwd.cuh, rays-in and xyz-in, with or
// without the stash, bf16), with its products on wgmma and its weights
// streamed by TMA.
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_fwd_kernel (the
// Pallas TPU kernel, forward, stash=False and stash=True) for the bf16
// shape that render_variant (ops/fused_render.py) gives to this kernel,
// the served MLPs': WP = 256, HP = 128, CP = 64, KE <= 128. The widths are
// template parameters; one instance is built for each form: the inference
// forward, which is also the no-stash training forward of routes A and B,
// and the stash forward, which the stash route's step runs and the
// recompute backward (fused_render_bwd_recompute.cu) runs again slab by
// slab. Included by fused_render_fwd.cu and fused_render_bwd_recompute.cu;
// fp32, other widths and the shapes the wgmma chain does not take
// (recompute_variant in ops/fused_render.py) stay on the mma.sync kernel.
//
// What bounds it: ~1.2 MFLOP of products a sample point at 8x256 against
// ~8 bytes of per-ray input a point: the tensor cores (5.23 ms at 8192 x
// 512 on an H100 SXM). The mma.sync kernel reached 17% of that because
// every warp read its weight fragments from L2 for 32 rows: 32 FLOP per
// byte loaded, ~5 TB/s of L2 traffic. Here each weight byte brought on
// chip serves 128 rows. Design:
//   * A persistent grid, one CTA an SM, walks work items: one ray (S > 64)
//     as tiles of 128 samples, or two rays (S <= 64) a tile. Rows past S
//     (and the second ray of an odd last pair) get alpha 0. The
//     transmittance is carried from tile to tile of a ray.
//   * Warpgroup 2 is the producer: one lane streams the whole weight
//     program of a tile (every layer's K-slices of 64, in the order the
//     products take them) with TMA bulk copies into an NS-slot mbarrier
//     ring. The slices are gathered on the host (pack_wgmma_b's layout,
//     wgmma_weights), each the 128-byte-swizzled image of B^T (N rows of 64
//     bf16, K-major), so a slice is one contiguous copy and needs no
//     tensor map. setmaxnreg cuts the producer to 40 registers a thread and
//     raises the consumers to 232: ptxas gives a wgmma kernel registers by
//     warpgroup, 168 at this size, and a 64 x 256 fp32 accumulator spills
//     at that.
//   * Two consumer warpgroups own 64 rows each and run wgmma m64nNk16 with
//     A (the encode or the activations, K-major, 128-byte swizzled) and B
//     (the ring slot) in shared memory, fp32 accumulators in registers. A
//     skip layer runs its encode slices and hidden slices into the same
//     accumulators. After the layer's last product has retired, each
//     warpgroup writes its epilogue (bias, ReLU, bf16) back into its own
//     64 activation rows: one buffer a warpgroup.
//   * The encode, the dir term (once per ray), sigma (a 64 x 8 product,
//     column 0), the compositing (warp 0 of each warpgroup, after the sigma
//     head, the second warpgroup's rows after the first's) and the feature
//     sums (the feature head's epilogue multiplies sigmoid(.) by the row's
//     weight and sums over rows) are SIMT on the rows each warpgroup owns.
//   * A product group is one slice's four k16 steps: the ring wait comes
//     before the group, the slot is released when the next group has
//     been committed and this one retired. Group shapes are template
//     parameters: a wait or a runtime branch inside a group makes ptxas
//     serialise every wgmma (note C7520; chip_smoke.py's build phase fails
//     on it).
//   * What holds it now (an H100): a grid of half the SMs takes twice
//     the time and a ring of two slots runs as fast as three, so neither
//     the L2 nor the weight stream's latency; the work between products
//     (each layer's wait and epilogue, the encode, the compositing), done
//     by both warpgroups at the same time, leaves the tensor cores idle.
//   * The stash (STASH): the instance with the stash adds stores and
//     nothing else, so its ray block and weights are the inference
//     instance's bits. Every buffer a product reads (the encode, each
//     trunk layer's ReLU output, hf, dd) is, once its epilogue is done, the
//     image of 64-column x 64-row boxes of the stash in the 128-byte
//     swizzle; one lane a warpgroup stores it by TMA through a 3-D tensor
//     map over (rays, samples, columns), which clips at S (a box never
//     reaches the next ray's rows) and at the row's end (the encode is 96
//     columns of the stash, 128 here). The stores run while the next
//     product does; the lane waits for them to have read the buffer
//     (bulk_wait_read) before the next epilogue writes it again. ~5 KB of
//     stash a point against ~1.2 MFLOP: per SM and tile ~25 us of device
//     memory against ~20 us of products at peak, so the stores must
//     overlap the products, which this order lets them do.
//   * Dtype policy as render_fwd_kernel: ReLU outputs, hf and dd rounded to
//     bf16; the sigma head at bf16 with fp32 accumulation; biases,
//     softplus, sigmoid and compositing fp32. The encode computes the same
//     values (sinf / cosf or the anchored recurrence). Sums run in another
//     order than the mma.sync kernel's, so the two agree to KERNEL_TOL,
//     not to the bit.

#pragma once

#include "fused_render_fwd.cuh"
#include "wgmma_tile.cuh"

namespace {

// floats of one warpgroup's SIMT state: sig, zc, nz, dl, wts (64 each),
// xyz (64 x 3), dirt (HP), the feature sums (2 x CP, by item parity) and
// the warps' partial sums (4 x CP)
template <int HP, int CP>
__host__ __device__ constexpr int wg_floats() {
  return 5 * WG_ROWS + 3 * WG_ROWS + HP + 6 * CP;
}

// bytes but the weight ring: 1024 to align, the barriers, the encode and
// activation buffers of both warpgroups, both warpgroups' floats and the
// shared tile / item scalars
template <int WP, int HP, int CP>
__host__ __device__ constexpr int wg_fixed_bytes() {
  return 1024 + 1024 + 2 * (KEW / 64) * A_SLICE + 2 * (WP / 64) * A_SLICE +
         (2 * wg_floats<HP, CP>() + 8) * 4;
}

template <int WP, int HP, int CP>
__host__ __device__ constexpr int wg_ring_slots() {
  constexpr int n = (WG_SMEM_MAX - wg_fixed_bytes<WP, HP, CP>()) / (WP * 128);
  return n < WG_MAX_NS ? n : WG_MAX_NS;
}

template <int WP, int HP, int CP>
__host__ __device__ constexpr int wg_smem_bytes() {
  return wg_fixed_bytes<WP, HP, CP>() + wg_ring_slots<WP, HP, CP>() * WP * 128;
}

// ------------------------------------------ the pieces of a tile's work
// What K1 and the ping-pong S2 (pipe_render_fwd_wgmma.cuh) run on a
// warpgroup's 64 rows. Every product goes over the weight ring. The hooks
// are K1's stash and S2's hand-over of the tensor cores: turn(n) before a
// product of n K-slices, done() once its last group is issued (both
// nothing in K1).

// The ray's dir term, once: dir encode @ W_dir_enc (fp32 sums of
// compute-dtype operands) into dirt (HP).
template <int HP>
__device__ __forceinline__ void wg_dir_term(const KArgs& a, int ray,
                                            float* dirt, int wtid) {
  for (int n = wtid; n < HP; n += 128) {
    const float* db = a.dirb + (size_t)ray * a.DK;
    float s = 0.f;
    for (int e = 0; e < a.DK; ++e) s += db[e] * a.wde[e * HP + n];
    dirt[n] = s;
  }
}

// The rows' scalars from sample sb of the ray on (rows past S repeat the
// last sample; row_scalars) and the encode of their points (o + d z, or the
// points xr) into enc, zero past 3 + 6F. before() runs between the two,
// ahead of the barrier before the encode's stores (the stash forward waits
// there for its stores to have read enc).
template <class Sync, class Before>
__device__ __forceinline__ void wg_tile_encode(
    const KArgs& a, uint8_t* enc, float* xyz, float* zc, float* nz,
    float* dl, const float* zr, const float* nr, const float* xr,
    const float (&o)[3], const float (&d)[3], int sb, int wtid, Sync wg_sync,
    Before before) {
  if (wtid < WG_ROWS)
    row_scalars(zr, nr, a.S, sb + wtid, zc[wtid], nz[wtid], dl[wtid]);
  before();
  wg_sync();
  // encode: [x, sin 2^0 x, cos 2^0 x, sin 2^1 x, ...], zero past 3 + 6F
  for (int i = wtid; i < WG_ROWS * 3; i += 128) {
    const int r = i / 3, c = i % 3;
    const float x = xr ? xr[min(sb + r, a.S - 1) * 3 + c]
                       : __fadd_rn(o[c], __fmul_rn(d[c], zc[r]));
    xyz[i] = x;
    st_bf16(enc, r, c, x);
  }
  wg_encode_pad(enc, a.F, wtid);
  wg_sync();
  wg_encode_sincos(enc, xyz, a.F, a.exact, wtid);
  fence_proxy_async();
  wg_sync();
}

// The sigma head: column 0 of a 64 x 8 product of h_{L-1} (act) into sig;
// done() once it is issued.
template <int WP, int NS, int SLOT, class Sync, class Done>
__device__ __forceinline__ void wg_sigma_head(const KArgs& a, uint32_t act_a,
                                              float* sig, uint32_t ring_a,
                                              uint64_t* full, uint64_t* empty,
                                              Ring& rg, bool leader, int r0,
                                              int lane, Sync wg_sync,
                                              Done done) {
  float acc_s[SIG_N / 2];
  zero_acc(acc_s);
  wg_product<SIG_N, NS, SLOT>(
      acc_s, WP / 64, [&](int kc) { return act_a + kc * A_SLICE; }, ring_a,
      full, empty, rg, leader, LocalRelease{}, done);
  if ((lane & 3) == 0) {
    sig[r0] = acc_s[0] + a.bs[0];
    sig[r0 + 8] = acc_s[2] + a.bs[0];
  }
  wg_sync();
}

// The compositing scan of the rows on warp 0, two rows a lane (2 lane,
// 2 lane + 1): their alphas (0 past S or for a missing ray), the product
// of (1 - alpha) over the rows before the lane's (excl) and over all 64
// (total).
__device__ __forceinline__ void wg_composite_scan(const float* sig,
                                                  const float* nz,
                                                  const float* dl,
                                                  bool ray_ok, int sb, int S,
                                                  int lane, float (&al)[2],
                                                  float& excl, float& total) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = 2 * lane + q;
    const float actv = fmaxf(softplusf(sig[r]) + nz[r], 0.f);
    al[q] = (ray_ok && sb + r < S) ? 1.f - expf(-dl[r] * actv) : 0.f;
  }
  float incl = (1.f - al[0]) * (1.f - al[1]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl *= y;
  }
  excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 1.f;
  total = __shfl_sync(0xffffffffu, incl, 31);
}

// The rows' weights from the transmittance t0_in entering them, into wts
// and, where wo (the ray's row of the weights output) is given, into its
// samples < S -> the rows' depth sum, in every lane of warp 0.
__device__ __forceinline__ float wg_composite_weights(
    float t0_in, const float (&al)[2], float excl, const float* zc,
    float* wts, float* wo, int sb, int S, int lane) {
  const float t0 = t0_in * excl;
  const float w0 = al[0] * t0;
  const float w1 = al[1] * (t0 * (1.f - al[0]));
  const int ra = 2 * lane;
  wts[ra] = w0;
  wts[ra + 1] = w1;
  if (wo != nullptr) {
    if (sb + ra < S) wo[sb + ra] = w0;
    if (sb + ra + 1 < S) wo[sb + ra + 1] = w1;
  }
  float pd = w0 * zc[ra] + w1 * zc[ra + 1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pd += __shfl_xor_sync(0xffffffffu, pd, off);
  return pd;
}

// The heads after sigma (h_{L-1} in act): hf = h @ W_f + b_f, then dd =
// relu(hf @ W_dh + dir term + b_d), both in place, then the feature head
// sigmoid(dd @ W_c + b_c) times each row's weight (wts), summed over the
// rows onto fm[0 .. CP) in warp order (red: the warps' sums).
// before_epi() runs before the barrier ahead of the hf and dd epilogues
// (the stash's wait), after_epi(col, nslices) once hf or dd is written
// (their stash stores).
template <int WP, int HP, int CP, int NS, int SLOT, class Sync, class Turn,
          class Done, class BeforeEpi, class AfterEpi>
__device__ __forceinline__ void wg_heads(
    const KArgs& a, float (&acc)[WP / 2], uint8_t* act, uint32_t act_a,
    const float* dirt, const float* wts, float* red, float* fm,
    uint32_t ring_a, uint64_t* full, uint64_t* empty, Ring& rg, bool leader,
    int warp, int lane, int wtid, int r0, int cq, int o_hf, int o_dd,
    Sync wg_sync, Turn turn, Done done, BeforeEpi before_epi,
    AfterEpi after_epi) {
  // ---- xyz_encoding_final: hf = h @ W_f + b_f, in place
  turn(WP / 64);
  zero_acc(acc);
  wg_product<WP, NS, SLOT>(
      acc, WP / 64, [&](int kc) { return act_a + kc * A_SLICE; }, ring_a,
      full, empty, rg, leader, LocalRelease{}, done);
  before_epi();
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
  after_epi(o_hf, WP / 64);

  // ---- dir branch: dd = relu(hf @ W_dh + dir term + b_d), in place
  {
    float acc_d[HP / 2];
    turn(WP / 64);
    zero_acc(acc_d);
    wg_product<HP, NS, SLOT>(
        acc_d, WP / 64, [&](int kc) { return act_a + kc * A_SLICE; },
        ring_a, full, empty, rg, leader, LocalRelease{}, done);
    before_epi();
    wg_sync();
#pragma unroll
    for (int nb = 0; nb < HP / 8; ++nb) {
      const int c = nb * 8 + cq;
      const float e0 = dirt[c], e1 = dirt[c + 1];
      const float b0 = a.bd[c], b1 = a.bd[c + 1];
      st_bf16x2(act, r0, c, fmaxf(acc_d[nb * 4] + e0 + b0, 0.f),
                fmaxf(acc_d[nb * 4 + 1] + e1 + b1, 0.f));
      st_bf16x2(act, r0 + 8, c, fmaxf(acc_d[nb * 4 + 2] + e0 + b0, 0.f),
                fmaxf(acc_d[nb * 4 + 3] + e1 + b1, 0.f));
    }
  }
  fence_proxy_async();
  wg_sync();
  after_epi(o_dd, HP / 64);

  // ---- feature head: sigmoid(dd @ W_c + b_c), times the row's weight,
  // summed over the rows
  {
    float acc_c[CP / 2];
    turn(HP / 64);
    zero_acc(acc_c);
    wg_product<CP, NS, SLOT>(
        acc_c, HP / 64, [&](int kc) { return act_a + kc * A_SLICE; },
        ring_a, full, empty, rg, leader, LocalRelease{}, done);
    const float wa = wts[r0], wb = wts[r0 + 8];
#pragma unroll
    for (int nb = 0; nb < CP / 8; ++nb) {
      const int c = nb * 8 + cq;
      const float b0 = a.bc[c], b1 = a.bc[c + 1];
      float p0 = wa * (1.f / (1.f + expf(-(acc_c[nb * 4] + b0)))) +
                 wb * (1.f / (1.f + expf(-(acc_c[nb * 4 + 2] + b0))));
      float p1 = wa * (1.f / (1.f + expf(-(acc_c[nb * 4 + 1] + b1)))) +
                 wb * (1.f / (1.f + expf(-(acc_c[nb * 4 + 3] + b1))));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      }
      if (lane < 4) {
        red[warp * CP + c] = p0;
        red[warp * CP + c + 1] = p1;
      }
    }
    wg_sync();
    for (int c = wtid; c < CP; c += 128)
      fm[c] += (red[c] + red[CP + c]) + (red[2 * CP + c] + red[3 * CP + c]);
  }
}

// ------------------------------------------------------------- kernel
// pair: S <= 64, two rays a tile (warpgroup g takes ray 2 item + g);
// else one ray an item, tiles of 128 samples (warpgroup g takes samples
// 128 t + 64 g ..). STASH: each activation buffer, once written, is also
// stored by TMA (smap, ray_rows_map over the stash) into its columns of the
// warpgroup's 64 stash rows while the next product runs.
template <int WP, int HP, int CP, bool STASH>
__global__ void __launch_bounds__(WG_THREADS, 1)
    render_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap smap,
                            const KArgs a, const uint8_t* __restrict__ wpack,
                            const int pair) {
  constexpr int SLOT = WP * 128;
  constexpr int NS = wg_ring_slots<WP, HP, CP>();
  constexpr int NF = wg_floats<HP, CP>();
  static_assert(NS >= 2, "no room for the weight ring");
  static_assert(WP % 64 == 0 && HP % 64 == 0 && CP % 64 == 0 && WP <= 256,
                "widths");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // barriers, the weight ring, both warpgroups' encode and activation
  // buffers (all on 1024-byte boundaries), then the floats
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WG_MAX_NS;
  uint8_t* ring = smem + 1024;
  uint8_t* encb = ring + NS * SLOT;
  uint8_t* actb = encb + 2 * (KEW / 64) * A_SLICE;
  float* fl = reinterpret_cast<float*>(actb + 2 * (WP / 64) * A_SLICE);
  float* tot = fl + 2 * NF;        // [tile parity][warpgroup]
  float* depb = tot + 4;           // [item parity][warpgroup]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int S = a.S, L = a.L;
  const int items = pair ? (a.N + 1) / 2 : a.N;
  const int tiles = pair ? 1 : (S + 127) / 128;

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
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      for (int t = 0; t < tiles; ++t) {
        const uint8_t* p = wg_put_trunk<WP, SLOT>(wpack, L, a.skip_mask, put);
        for (int k = 0; k < WP / 64; ++k, p += SIG_N * 128)
          put(p, SIG_N * 128);
        for (int k = 0; k < WP / 64; ++k, p += WP * 128) put(p, WP * 128);
        for (int k = 0; k < WP / 64; ++k, p += HP * 128) put(p, HP * 128);
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
  auto both_sync = [&]() { named_bar_sync(1, 256); };
  auto nothing = [&]() {};

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
  float* fm = dirt + HP;           // [item parity][CP]
  float* red = fm + 2 * CP;        // [warp][CP]
  float* fm0 = fl + HP + 8 * WG_ROWS;  // warpgroup 0's feature sums

  // the accumulator fragment: rows r0 and r0 + 8, columns 8 nb + cq (+1)
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  // the stash row's columns: h_i at i WP, then hf, dd, the encode
  const int o_hf = L * WP, o_dd = o_hf + WP, o_enc = o_dd + HP;

  Ring rg;
  int tp = 0, ip = 0;
  float acc[WP / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int ray_raw = pair ? 2 * item + g : item;
    const bool ray_ok = ray_raw < a.N;
    const int ray = ray_ok ? ray_raw : a.N - 1;
    wg_dir_term<HP>(a, ray, dirt, wtid);
    for (int c = wtid; c < CP; c += 128) fm[ip * CP + c] = 0.f;
    const float* xr = a.xyz ? a.xyz + (size_t)ray * S * 3 : nullptr;
    float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    if (xr == nullptr) {
      const float* od = a.od + (size_t)ray * 8;
      o[0] = od[0]; o[1] = od[1]; o[2] = od[2];
      d[0] = od[3]; d[1] = od[4]; d[2] = od[5];
    }
    const float* zr = a.z + (size_t)ray * S;
    const float* nr = a.noise + (size_t)ray * S;
    float t_carry = 1.f;  // transmittance entering the tile (warp 0)
    float dep = 0.f;      // this warpgroup's depth sum (warp 0)

    for (int t = 0; t < tiles; ++t) {
      const int sb = pair ? 0 : t * 128 + g * WG_ROWS;  // row 0's sample
      // STASH: nslices 64-column slices of buf into stash columns col..
      // of this warpgroup's rows (clipped at S; none for a missing ray)
      auto stash_store = [&](const uint8_t* buf, int nslices, int col) {
        if constexpr (STASH) {
          if (leader && ray_ok && sb < S) {
            for (int k = 0; k < nslices; ++k)
              tma_store_3d(&smap, buf + k * A_SLICE, col + 64 * k, sb, ray);
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
      wg_tile_encode(a, enc, xyz, zc, nz, dl, zr, nr, xr, o, d, sb, wtid,
                     wg_sync, stash_wait);
      stash_store(enc, KEW / 64, o_enc);

      // ---- trunk: h_i = relu([enc |] h_{i-1} @ W_i + b_i), in place
      wg_trunk<WP, NS, SLOT>(
          a, acc, enc_a, act_a, act, ring_a, full, empty, rg, leader, r0,
          cq, wg_sync, stash_wait,
          [&](int i) { stash_store(act, WP / 64, i * WP); });

      wg_sigma_head<WP, NS, SLOT>(a, act_a, sig, ring_a, full, empty, rg,
                                  leader, r0, lane, wg_sync, nothing);

      // ---- compositing, warp 0 of each warpgroup, two rows a lane; the
      // second warpgroup's rows of a ray's tile come after the first's
      {
        float al[2] = {0.f, 0.f}, excl = 1.f, total = 1.f;
        if (warp == 0) {
          wg_composite_scan(sig, nz, dl, ray_ok, sb, S, lane, al, excl,
                            total);
          if (lane == 0) tot[tp * 2 + g] = total;
        }
        both_sync();
        if (warp == 0) {
          const float t0_in =
              (pair || g == 0) ? t_carry : t_carry * tot[tp * 2];
          t_carry = pair ? t_carry * total
                         : (t_carry * tot[tp * 2]) * tot[tp * 2 + 1];
          dep += wg_composite_weights(
              t0_in, al, excl, zc, wts,
              (a.wout != nullptr && ray_ok) ? a.wout + (size_t)ray * S
                                            : nullptr,
              sb, S, lane);
        }
        tp ^= 1;
      }

      wg_heads<WP, HP, CP, NS, SLOT>(
          a, acc, act, act_a, dirt, wts, red, fm + ip * CP, ring_a, full,
          empty, rg, leader, warp, lane, wtid, r0, cq, o_hf, o_dd, wg_sync,
          [](int) {}, nothing, stash_wait,
          [&](int col, int nslices) { stash_store(act, nslices, col); });
    }

    // ---- the item's ray block(s): [feature map | depth | 0]
    if (warp == 0 && lane == 0) depb[ip * 2 + g] = dep;
    both_sync();
    if (a.out != nullptr && (pair ? ray_ok : g == 0)) {
      float* orow = a.out + (size_t)ray * a.ldo;
      const float* fa = fm + ip * CP;
      const float* fb = fm0 + NF + ip * CP;  // warpgroup 1's sums
      for (int c = wtid; c < a.ldo; c += 128) {
        float v = 0.f;
        if (c < a.C) v = pair ? fa[c] : fa[c] + fb[c];
        else if (c == a.C)
          v = pair ? depb[ip * 2 + g] : depb[ip * 2] + depb[ip * 2 + 1];
        orow[c] = v;
      }
    }
    ip ^= 1;
  }
  if constexpr (STASH) {
    if (leader) bulk_wait();
  }
}

// Launches render_fwd_wgmma_kernel<WP, HP, CP, STASH> on ``st`` over
// min(items, SMs) CTAs; cudaGetLastError().
template <int WP, int HP, int CP, bool STASH>
int launch_wgmma(const CUtensorMap& smap, const KArgs& a, const void* wpack,
                 cudaStream_t st) {
  constexpr int smem = wg_smem_bytes<WP, HP, CP>();
  static_assert(smem <= WG_SMEM_MAX, "shared memory");
  auto kern = render_fwd_wgmma_kernel<WP, HP, CP, STASH>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int pair = a.S <= WG_ROWS;
  const int items = pair ? (a.N + 1) / 2 : a.N;
  const int grid = items < sms ? items : sms;
  kern<<<grid, WG_THREADS, smem, st>>>(
      smap, a, static_cast<const uint8_t*>(wpack), pair);
  return (int)cudaGetLastError();
}

// Arguments as render_fwd_entry takes them, and after them the weight
// stream (wgmma_weights in ops/fused_render.py). Only the shape this
// kernel takes: bf16, (WP, HP, CP) = (256, 128, 64), KE <= 128; with or
// without the stash (its columns as parse_fwd_args checks them, the row
// 16-byte aligned). Returns cudaGetLastError(), a CUresult of the stash's
// tensor map, or cudaErrorInvalidValue.
int render_fwd_wgmma_entry(const void* const* ptrs, int n_ptrs,
                           const int* dims, int n_dims, void* stream) {
  if (n_ptrs < 1) return (int)cudaErrorInvalidValue;
  KArgs a;
  bool bf16;
  const int rc = parse_fwd_args(ptrs, n_ptrs - 1, dims, n_dims, a, bf16);
  if (rc != 0) return rc;
  const void* wpack = ptrs[n_ptrs - 1];
  if (!bf16 || !wpack || ((uintptr_t)wpack & 15) || a.KE > KEW ||
      3 + 6 * a.F > KEW || a.WP != 256 || a.HP != 128 || a.CP != 64 ||
      (a.stash && (((uintptr_t)a.stash & 15) || a.SC % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap smap = {};
  if (!a.stash)
    return launch_wgmma<256, 128, 64, false>(smap, a, wpack, st);
  const int mrc = ray_rows_map(&smap, a.stash, a.N, a.S, a.SC);
  if (mrc != 0) return mrc;
  return launch_wgmma<256, 128, 64, true>(smap, a, wpack, st);
}

}  // namespace
