// Backward of the fused render pass WITHOUT a stash kept by the forward:
// weight and bias gradients of the NeRF MLP from the forward's inputs
// (origins and directions, or one coordinate per sample point; z; sigma
// noise), the cotangents and the weights. No gradient for rays, z or noise.
//
// Replaces crnerf_tpu/ops/fused_render.py:_make_render_bwd_kernel (the
// Pallas TPU kernel behind make_fused_render_train(stash=False), both
// rays_in forms). That kernel recomputes one tile's forward in VMEM,
// backpropagates through it and adds into gradient blocks that stay
// resident across a sequential grid. On this card no block can hold a ray
// chunk's activations of every layer (8 x 64 x 256 bf16 = 256 KB, over the
// 227 KB a block may have) nor 0.6 M gradient values, so the recompute goes
// through device memory, but through a scratch of a fixed size:
//
//   for each slab of R rays, in ray order
//     1. the forward kernel's stash instantiation (rays-in or xyz-in) fills
//        the slab stash; its ray block and weights are not written, the
//        forward proper already returned them;
//     2. the chain kernel fills the slab dz buffer from the slab stash and
//        the slab's rows of the cotangents;
//     3. the split-K weight-gradient kernel (fused_render_bwd.cuh) writes
//        its partial tiles;
//     4. the fixed-order sums of 2. and 3. add onto the gradients of the
//        slabs before.
//
// The stash and dz buffers hold R rays whatever N is, and are reused by
// every slab: nothing lives from forward to backward, and the scratch does
// not grow with the batch. All launches are on one stream, so a slab's
// kernels find the buffers free. Every sum has a fixed order (within a
// slab as in the stash backward, across slabs in slab order): two runs on
// the same inputs give the same bits.
//
// Two entries, one slab loop; the variant is chosen on the host by shape
// (recompute_variant in ops/fused_render.py), and the no-stash training
// forward of the same pass takes the same variant, so that the slabs
// recompute the bits that forward computed (a ReLU mask open on one side
// and shut on the other would move a point's whole gradient term):
//   * crnerf_render_bwd_recompute_wgmma, at bf16 and the served widths with
//     at most 8 trunk layers and 256 samples: 1. is the wgmma forward's
//     STASH instance (fused_render_fwd_wgmma.cuh), which adds stores to
//     the inference instance and nothing else, so its rows are the bits of
//     the wgmma inference forward that routes A and B run; its stash
//     tensor map covers the slab's rays; 2. is the wgmma chain
//     (fused_render_bwd_wgmma.cuh), its sums added onto the slabs before.
//     A slab is a whole number of those kernels' waves of items, so no
//     slab ends in a nearly empty wave. Each slab's stash and dz rows are
//     bit for bit those the stash route's (wgmma) pair writes for the same
//     rays.
//   * crnerf_render_bwd_recompute (fp32, other widths, deeper trunks, more
//     samples): 1. and 2. on the mma.sync kernels (fused_render_fwd.cuh,
//     fused_render_bwd.cuh), whose rows are bit for bit the mma.sync stash
//     pair's (the stash route's pair at those shapes), and the mma.sync
//     forward is that of the no-stash training forward.
// Step 3 is K2's weight gradient in both, the kernel the Python side names
// (wgrad_variant: wgmma at bf16 and the served widths, wgrad_wgmma.cuh).
// The gradients differ from the stash route's only in how the fp32 sums
// over the points are grouped.
//
// What bounds it: the forward again (~1.2 MFLOP per point at 8x256) and the
// backward (~2.4 MFLOP per point) against a few bytes of input per point:
// operations. What it costs as built: the stash and dz traffic of the
// stash route (~15 KB per point written and read back, much of a slab's
// from the 50 MB L2 only when the slab is small) plus one more forward.
// Left for later: chaining from shared memory so that neither the stash nor
// dz reaches device memory.

#include <algorithm>

#include "fused_render_bwd_wgmma.cuh"
#include "fused_render_fwd_wgmma.cuh"

namespace {

constexpr int RC_PTRS = 20;    // pointers before whT[1 .. L-1] (mma.sync)
constexpr int RCW_PTRS = 19;   // pointers before the forward's (wgmma)
constexpr int RC_DIMS = 24;
constexpr int FWD_W = 9;       // ws, bs, wf, bf, wdh, bd, wde, wc, bc

const float* rows(const void* base, size_t row, size_t width) {
  return base ? static_cast<const float*>(base) + row * width : nullptr;
}

// The slab loop of both entries (their pointers and dims below).
int recompute_slabs(const void* const* ptrs, int n_ptrs, const int* dims,
                    int n_dims, void* stream, bool wgmma) {
  if (n_dims != RC_DIMS) return (int)cudaErrorInvalidValue;
  const int N = dims[0], S = dims[1], L = dims[2], HP = dims[5];
  const int DK = dims[10], ldo = dims[12], SC = dims[14], DC = dims[15];
  const int slices = dims[16], grid = dims[17], R = dims[22];
  if (N < 1 || S < 1 || L < 1 || L > MAXL || R < 1 || grid < 1 || slices < 1)
    return (int)cudaErrorInvalidValue;
  const int n_head = wgmma ? RCW_PTRS : RC_PTRS + (L - 1);
  if (n_ptrs != n_head + FWD_W + 3 * L) return (int)cudaErrorInvalidValue;
  for (int i = 2; i < n_head; ++i)
    if (!ptrs[i]) return (int)cudaErrorInvalidValue;
  const void* const* fw = ptrs + n_head;  // ws, bs, ..., bc, layer triples

  // the forward's pointers: no ray block, no weights out, the slab stash
  const void* fp[FWD_PTRS + 3 * MAXL + 1];
  for (int i = 0; i < FWD_W + 3 * L; ++i) fp[8 + i] = fw[i];
  fp[4] = nullptr; fp[5] = nullptr;
  fp[6] = ptrs[7];
  int n_fp = FWD_PTRS + 3 * L;
  if (wgmma) fp[n_fp++] = ptrs[18];       // the forward's weight stream
  // the chain's: the slab's rows (set per slab), the stash, the dz rows,
  // its scratch and bout, then its weights
  const void* cp[CHAIN_PTRS + MAXL];
  for (int i = 5; i < 11; ++i) cp[i] = ptrs[2 + i];
  int n_cp;
  if (wgmma) {
    cp[11] = fw[1]; cp[12] = fw[8];       // bs, bc
    cp[13] = ptrs[16]; cp[14] = ptrs[17]; // wsv, the chain's stream
    n_cp = CW_PTRS;
  } else {
    cp[11] = fw[0]; cp[12] = fw[1];       // ws, bs
    cp[13] = fw[7]; cp[14] = fw[8];       // wc, bc
    for (int i = 0; i < 4 + (L - 1); ++i) cp[15 + i] = ptrs[16 + i];
    n_cp = CHAIN_PTRS + (L - 1);
  }
  const void* wp[WGRAD_PTRS] = {ptrs[7], ptrs[8], ptrs[13], ptrs[14],
                                ptrs[15]};

  for (int r0 = 0; r0 < N; r0 += R) {
    const int n = std::min(R, N - r0);
    const bool accumulate = r0 > 0;
    fp[0] = rows(ptrs[0], r0, 8);
    fp[7] = rows(ptrs[1], (size_t)r0 * S, 3);
    fp[1] = cp[0] = rows(ptrs[2], r0, S);
    fp[2] = cp[1] = rows(ptrs[3], r0, S);
    fp[3] = cp[2] = rows(ptrs[4], r0, DK);
    cp[3] = rows(ptrs[5], r0, ldo);
    cp[4] = rows(ptrs[6], r0, S);
    int fd[FWD_DIMS];
    for (int i = 0; i < FWD_DIMS; ++i) fd[i] = dims[i];
    fd[0] = n;
    int rc = wgmma ? render_fwd_wgmma_entry(fp, n_fp, fd, FWD_DIMS, stream)
                   : render_fwd_entry(fp, n_fp, fd, FWD_DIMS, stream);
    if (rc != 0) return rc;
    // the chain's grid: at most its items (rays, or with wgmma pairs of
    // rays when S <= 64)
    const int items = wgmma && S <= WG_ROWS ? (n + 1) / 2 : n;
    // N, S, L, WP, HP, CP, C, DK, ldo, SC, DC, slices, BF16, grid
    const int cd[CHAIN_DIMS] = {n, S, L, dims[4], HP, dims[6], dims[7], DK,
                                ldo, SC, DC, std::min(slices, n), dims[13],
                                std::min(grid, items)};
    rc = wgmma ? render_bwd_chain_wgmma_entry(cp, n_cp, cd, CHAIN_DIMS,
                                              stream, accumulate)
               : render_bwd_chain_entry(cp, n_cp, cd, CHAIN_DIMS, stream,
                                        accumulate);
    if (rc != 0) return rc;
    // M, SC, DC, WT, n_tiles, splits, m_per, kernel
    const int wd[WGRAD_DIMS] = {n * S, SC, DC, dims[18], dims[19], dims[20],
                                dims[21], dims[23]};
    rc = render_bwd_wgrad_entry(wp, WGRAD_PTRS, wd, WGRAD_DIMS, stream,
                                accumulate);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// ptrs (host array): od (0 with xyz), xyz (0: rays-in), z, noise, dirb, gray,
// gw, stash (R*S x SC scratch), dzbuf (R*S x DC scratch), bpart (grid x DC),
// ddray (R x HP), dpart (slices x DK*HP), bout (DC + DK*HP), tiles, part
// (splits x WT), wout (WT), wsv, wcT, wdhT, wfT, whT[1 .. L-1], then the
// forward's weights as crnerf_render_fwd takes them (ws .. bc, then per
// trunk layer wenc, wh, b).
// dims: N, S, L, skip_mask, WP, HP, CP, C, KE, F, DK, exact, ldo, BF16, SC,
// DC, slices, grid, WT, n_tiles, splits, m_per, R, WK (the weight
// gradient's kernel, as render_bwd_wgrad_entry takes it; the tile table
// is that kernel's). ``splits`` and ``m_per`` cut R*S points; ``grid`` and
// ``slices`` are at most R.
// Writes bout and wout; returns the first error of any launch.
extern "C" int crnerf_render_bwd_recompute(const void* const* ptrs,
                                           int n_ptrs, const int* dims,
                                           int n_dims, void* stream) {
  return recompute_slabs(ptrs, n_ptrs, dims, n_dims, stream, false);
}

// ptrs: as crnerf_render_bwd_recompute's up to wsv, then the wgmma chain's
// weight stream (wgmma_chain_weights), the wgmma forward's
// (wgmma_weights), then the forward's weights. dims as there, ``grid`` at
// most the wgmma chain's items over R rays. Only the shapes both wgmma
// kernels take (each entry refuses others).
extern "C" int crnerf_render_bwd_recompute_wgmma(const void* const* ptrs,
                                                 int n_ptrs, const int* dims,
                                                 int n_dims, void* stream) {
  return recompute_slabs(ptrs, n_ptrs, dims, n_dims, stream, true);
}
