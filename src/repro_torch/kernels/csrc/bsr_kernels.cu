// Hand-written Hopper (sm_90a) megakernel: the whole scheduled block-sparse
// net in one launch.  The single-layer kernel, bsr_matmul, lives in
// bsr_matmul.cu; both walk their blocks through split_k.cuh.
//
// bsr_megakernel_kernel replaces the Pallas kernel bsr_megakernel
// (src/repro/kernels/bsr_matmul.py, `bsr_megakernel` / body `_megakernel`):
// every layer of a flat cross-layer schedule in one launch, hidden
// activations kept in f32 and never written out in x's dtype, one hidden
// epilogue and one final epilogue.  Its gated instance (Gate = true)
// replaces the same Pallas kernel with gate=True (gating at
// bsr_matmul.py:208-217, occupancy counts at :258-262): see "Gating" below.
// These are the megakernel's split-K walk, for serving batches: a call of
// more than 32 rows whose every layer has at least 16 items (runs x 64-row
// tiles) takes the row-tiled walk instead (row_tile.cuh), as
// bsr_matmul.row_tiled(B, flat) decides.  What is said below of the output
// (bit-equal to two bsr_matmul launches with f32 x) holds for this walk.
//
// What bounds it on the H100.  It streams every scheduled weight block once;
// at the paper's BERT-large FFNN (1024 -> 4096 -> 1024, density 0.1, 128x128
// tiles) that is 4,259,840 B in f32 (65 blocks, patch blocks included, at
// chip_smoke.py's layout; the benchmark's layout schedules 66),
// 1.3 us at 3.35 TB/s.  The arithmetic, 2 * B * 128 * 128 per block, is far
// below the f32 FMA rate at serving batches (B <= 32).  So the floor is
// latency: the launch, a few dependent round trips to L2 per layer (the
// weights, the partials, the arrival, the reduction) and the barrier
// between layers, each exposed because a CTA of 4 warps has little else to
// switch to.  The first version gave each (output-tile run, 8-row chunk) to
// one CTA, whose threads walked the run's blocks in 128 dependent 4-byte
// loads each: 32 CTAs in layer 0 and 8 in layer 1 on 132 SMs, and few
// weight loads ever in flight.
//
// Design: bsr_matmul's split-K walk, layer by layer, in one cooperative
// launch.  A work item is (flat step g of layer k, K-slice s, chunk of
// kChunkRows = 32 batch rows); at the BERT net (f32, 32-row K-slices, 4 per
// block) that is 156 items in layer 0 and 104 in layer 1 per row chunk.
// The grid is the smaller of the co-resident CTA count (a cooperative launch
// requires it) and the most items of any layer; CTAs take a layer's items in
// a grid-stride loop, and a grid-wide barrier separates the layers.  Each
// item does what one bsr_matmul CTA does (split_k.cuh): its 16-byte weight
// loads first, its input slice staged as f32 (x in layer 0, the f32 hidden
// buffer through L2 in later layers), the slice's product reduced over row
// groups in a fixed order into an f32 partial, then its arrival on the
// (run, chunk) counter.  The last item to arrive sums the run's partials in
// schedule order, then K-slice order, adds the bias, applies the epilogue,
// writes the hidden tile (f32) or the output (x's dtype) and resets the
// counter.  So with f32 x the output is bit-equal to two bsr_matmul
// launches, which keep the hidden tile in f32 too.  The layers' first steps
// travel by value in the launch parameters, so an item finds its step
// without a load.
//
// Overlap across the barrier.  The barrier between layers is split: after
// it arrives and before it waits, each CTA reads what its first item of the
// next layer needs that does not depend on this layer (its step's
// metadata) and, in the ungated instance, issues its weight loads into
// registers: their latency hides behind this layer's tail and the barrier,
// which two launches cannot do.  Within an item, the run's
// metadata (its steps, output tile, bias row and first partial) is read
// while the weight loads are in flight, so the item that reduces the run
// starts on the partials as soon as it has arrived.
//
// The hidden activations live in a ping-pong buffer [2, hidden_tiles, B, bs]
// in global memory (16 KiB * B per buffer at the BERT width, far beyond a
// CTA's shared memory) and stay resident in the 50 MB L2; partials,
// hidden tiles and occupancy slots are written and read through L2
// (__stcg/__ldcg), since other CTAs of the launch produce them.
//
// Gating.  The gated instance takes occ0 [grid_in_0] (live-row counts of
// x's input tiles, computed by the wrapper on the card) and returns occ
// [max(1, n_layers-1), hidden_tiles].
//  * An item reads whether its input tile is live (occ0 > 0, staged in
//    shared memory at the start, for layer 0; any chunk's slot > 0 for
//    later layers).  A dead item loads no weights and stages nothing, so
//    the weight bytes of dead steps are never read (the TPU pipeline still
//    streamed them; here the read is what gating saves).  It writes a zero
//    partial and arrives, and the reducer sums every partial of the run as
//    the ungated reducer does.  The result is bit-equal to the ungated
//    one: a dead tile holds only +-0 in every valid row, so every product
//    fmaf(+-0, w, acc) of a finite weight onto an acc of +0 gives +0, each
//    slice sum (which starts at +0) is +0, and the ungated partial is +0
//    too.  Skipping the dead partials instead would give the same bits
//    (the run's sum starts at +0 and is never -0, since x + y rounds to -0
//    only when both are -0, so adding +0 changes nothing), but the reducer
//    would then need the run's liveness, step by step, before its loads,
//    which costs more than the zero stores.  An all-dead run still writes
//    act(bias).
//  * The reducer of hidden tile c and row chunk j counts the rows among
//    its valid ones (b < B) with any nonzero in what it wrote, in one
//    block-wide pass (a warp OR, then four words in shared memory), and
//    stores the count with a plain 8-byte store in slot (layer, c, j),
//    beside the launch's epoch: no atomics and no memset.  Layer k+1 treats
//    tile r as live if any chunk's slot is > 0.
//  * The epoch (a per-schedule launch count the wrapper passes) tells a slot
//    this launch wrote from a stale one, so a CTA need not wait for the
//    barrier to learn whether its first item of layer k+1 is live: between
//    its arrival at the barrier and its wait, it polls that tile's slots
//    until they carry this launch's epoch (the tile's reducers write them
//    before they arrive, and all CTAs are co-resident, so the poll ends),
//    and if the tile is live it issues the item's weight loads, as the
//    ungated instance does.
//    A dead tile's weights are still never read.
//  * After the last barrier one CTA writes every entry of occ: the sum
//    over chunks of this launch's slots, and 0 for tiles no layer writes
//    (their slots carry another epoch).
//
// The C entries of both walks live here: bsr_megakernel_prepare checks and
// packs what a flat schedule's launches share into a launch block
// (mega::Block, mega.cuh), once per schedule, walk, x dtype and width, and
// bsr_megakernel_prepared_launch checks one call's own values and launches
// from the block: this walk through split_k_walk, the row-tiled walk
// through mega::row_tiled{,_gated} (bsr_row_tiled{,_gated}.cu).  The host
// pays for a ctypes call by the argument, so a call passes 11.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the launch API's own error).  Launches of one flat
// schedule must be ordered on one stream: they share the arrival counters
// and the occupancy slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <utility>

#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

struct MegaParams {
  const void* x;            // [B, n_in], XT
  const void* blocks;       // [n_steps, bs, bs], WT, schedule order
  const int* rows;          // [n_steps] layer-local input tile
  const int* cols;          // [n_steps] layer-local output tile
  const int* run_ptr;       // [n_runs + 1] first step of every run
  const int* step_run;      // [n_steps] the run of every step
  const int* part_off;      // [n_steps] the first partial of every step
  const int* bias_idx;      // [n_steps] row of bias_tiles
  const float* bias_tiles;  // [sum of grid_out, bs]
  const float* scales;      // [n_steps] dequant factors, or null
  const int* occ0;          // Gate: [grid_in_0]
  // Gate: [max(1, n_layers-1), hidden_tiles, chunks], (epoch << 32) | count
  unsigned long long* slots;
  int* occ;                 // Gate: [max(1, n_layers-1), hidden_tiles]
  float* hidden;            // [2, hidden_tiles, B, bs]
  float* partial;           // [n_steps * n_slices, B, bs]
  int* arrivals;            // [n_runs, chunks], zero between launches
  void* out;                // [B, n_out], XT
  int B, n_in, n_out, bs, n_layers, hidden_tiles, k_slice, n_slices;
  int act, final_act;
  unsigned epoch;           // Gate: this launch's tag on the slots, not 0
  int seg[kMaxLayers + 1];  // first flat step of every layer, then n_steps
};

// Dynamic shared memory of one CTA, in 4-byte words: one work item's
// staging and reduction and, gated, one word per input tile of layer 0
// (its liveness).
template <bool Gate, int VE>
__host__ __device__ constexpr size_t mega_smem_words(int k_slice, int bs,
                                                     int in_tiles0) {
  return item_smem_floats<VE>(k_slice, bs) + (Gate ? (size_t)in_tiles0 : 0);
}

template <bool Gate, typename XT, typename WT, int VE>
__global__ void __launch_bounds__(kThreads)
    bsr_megakernel_kernel(const __grid_constant__ MegaParams p) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  __shared__ unsigned warp_rows[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const XT* x = static_cast<const XT*>(p.x);
  const WT* blocks = static_cast<const WT*>(p.blocks);
  XT* out = static_cast<XT*>(p.out);
  const Lanes<VE> lanes(p.bs);
  const int bs = p.bs;
  const int B = p.B;
  const int chunks = (B + kChunkRows - 1) / kChunkRows;
  const size_t hbuf = (size_t)p.hidden_tiles * B * bs;
  const size_t part_stride = (size_t)B * bs;
  const int in_tiles0 = p.n_in / bs;
  float* xs = smem;                          // [k_slice][kXsStride]
  float* red = smem + xs_floats(p.k_slice);  // [kgs][kSubRows][bs]
  // Gate: the liveness of layer 0's input tiles
  int* tile_ok =
      reinterpret_cast<int*>(smem + item_smem_floats<VE>(p.k_slice, bs));

  auto items_of = [&](int k) {
    return (p.seg[k + 1] - p.seg[k]) * p.n_slices * chunks;
  };
  // work item `it` of layer k: (step g, K-slice s, row chunk), decoded
  // from the segment table alone, and the loads that need only g, issued
  // at once; nothing waits on them until they are used
  struct Work {
    int g, s, chunk, r, run, c, bias_row;
    float sc;
  };
  auto begin = [&](int k, int it) {
    const int per_chunk = (p.seg[k + 1] - p.seg[k]) * p.n_slices;
    Work m;
    m.chunk = it / per_chunk;
    const int q = it - m.chunk * per_chunk;
    const int gl = q / p.n_slices;
    m.g = p.seg[k] + gl;
    m.s = q - gl * p.n_slices;
    m.r = p.rows[m.g];
    m.run = p.step_run[m.g];
    m.c = p.cols[m.g];
    m.bias_row = p.bias_idx[m.g];
    m.sc = p.scales != nullptr ? p.scales[m.g] : 1.f;
    return m;
  };
  auto load_weights = [&](WRegs<WT, VE>& w, const Work& m) {
    const int k0 = m.s * p.k_slice;
    load_slice<WT, VE>(w, blocks + ((size_t)m.g * bs + k0) * bs,
                       min(p.k_slice, bs - k0), bs, lanes);
  };
  // Gate: the slots of hidden tile c of layer k
  auto slots_of = [&](int k, int c) {
    return p.slots + ((size_t)k * p.hidden_tiles + c) * chunks;
  };
  // Gate: input tile r of layer k holds a nonzero in a valid row
  auto tile_live = [&](int k, int r) {
    if (k == 0) return tile_ok[r] != 0;
    const unsigned long long* sl = slots_of(k - 1, r);
    bool any = false;
    for (int j = 0; j < chunks; ++j)
      any |= slot_count(__ldcg(sl + j), p.epoch) > 0;
    return any;
  };

  WRegs<WT, VE> w;
  bool held = false;        // w holds the weights of `first`
  Work first{};             // this CTA's first item of the current layer
  bool first_live = false;  // Gate, layers after 0: `first` reads a live tile
  // Gate: layer 0's first input tiles' occupancy, read beside `first`
  const int occ_t =
      Gate && (int)threadIdx.x < in_tiles0 ? __ldg(p.occ0 + threadIdx.x) : 0;
  if ((int)blockIdx.x < items_of(0)) {
    first = begin(0, blockIdx.x);
    if (!Gate) {
      load_weights(w, first);
      held = true;
    }
  }
  for (int k = 0; k < p.n_layers; ++k) {
    const bool is_final = k == p.n_layers - 1;
    const int act = is_final ? p.final_act : p.act;
    const float* h_in = p.hidden + (size_t)((k + 1) % 2) * hbuf;
    float* h_out = p.hidden + (size_t)(k % 2) * hbuf;
    const int items = items_of(k);
    if constexpr (Gate) {
      if (k == 0) {
        for (int t = threadIdx.x; t < in_tiles0; t += kThreads)
          tile_ok[t] = (t < kThreads ? occ_t : __ldg(p.occ0 + t)) > 0;
        __syncthreads();
      }
      if (is_final && blockIdx.x == gridDim.x - 1)
        sum_occupancy<kThreads>(p, chunks);
    }
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const bool is_first = it == (int)blockIdx.x;
      const Work m = is_first ? first : begin(k, it);
      const int b0 = m.chunk * kChunkRows;
      const int nrows = min(kChunkRows, B - b0);
      const int k0 = m.s * p.k_slice;
      const int kn = min(p.k_slice, bs - k0);
      bool alive = true;
      if constexpr (Gate)
        alive = k > 0 && is_first ? first_live : tile_live(k, m.r);
      if (alive && !held) load_weights(w, m);
      held = false;
      if (alive) {
        if (k == 0) {
          stage_slice<false>(xs,
                             x + (size_t)b0 * p.n_in + (size_t)m.r * bs + k0,
                             p.n_in, nrows, p.k_slice, kn);
        } else {
          stage_slice<true>(xs, h_in + ((size_t)m.r * B + b0) * bs + k0, bs,
                            nrows, p.k_slice, kn);
        }
      }
      const int g0 = p.run_ptr[m.run];
      const int g1 = p.run_ptr[m.run + 1];
      float* part = p.partial + ((size_t)(p.part_off[m.g] + m.s) * B + b0) * bs;
      if (alive) {
        __syncthreads();
        slice_product<WT, VE>(w, m.sc, xs, red, part, nrows, kn, bs, lanes);
      } else {
        // a dead step's partial is +0, which its ungated product would be
        for (int o = threadIdx.x; o < nrows * bs; o += kThreads)
          __stcg(part + o, 0.f);
      }
      const int p0 = p.part_off[g0];
      if (!arrive(p.arrivals + (size_t)m.run * chunks + m.chunk,
                  (g1 - g0) * p.n_slices, &is_last))
        continue;
      // the last item of the (run, chunk): reduce it
      const float* part0 = p.partial + ((size_t)p0 * B + b0) * bs;
      const float* bias = p.bias_tiles + (size_t)m.bias_row * bs;
      if (is_final) {
        reduce_run(part0, g1 - g0, p.n_slices, part_stride, nrows, bs, bias,
                   act,
                   OutTile<XT>{out + (size_t)b0 * p.n_out + (size_t)m.c * bs,
                               p.n_out});
        continue;
      }
      float* h = h_out + ((size_t)m.c * B + b0) * bs;
      unsigned nz = 0;  // Gate: bit i set when row b0+i is nonzero in tile c
      reduce_run(part0, g1 - g0, p.n_slices, part_stride, nrows, bs, bias,
                 act, [&](int i, int n, float y) {
                   __stcg(h + (size_t)i * bs + n, y);
                   if (Gate && y != 0.f) nz |= 1u << i;
                 });
      if constexpr (Gate) {
        // the rows of tile c that hold a nonzero, counted in one pass
        const int warp = threadIdx.x >> 5;
        nz = __reduce_or_sync(0xffffffffu, nz);
        if ((threadIdx.x & 31) == 0) warp_rows[warp] = nz;
        __syncthreads();
        if (threadIdx.x == 0) {
          unsigned rows_nz = 0;
          for (int q = 0; q < kThreads / 32; ++q) rows_nz |= warp_rows[q];
          slots_of(k, m.c)[m.chunk] =
              (unsigned long long)p.epoch << 32 | __popc(rows_nz);
        }
      }
    }
    if (is_final) break;
    // layer k's hidden tiles (and, gated, their occupancy) are complete
    // once the barrier is passed.  Between its arrival and its wait, each
    // CTA reads what its first item of layer k+1 needs that does not depend
    // on layer k, and loads its weights: at once when ungated; gated, once
    // the slots of its input tile carry this launch's epoch, and only if
    // that tile is live.
    cg::grid_group::arrival_token token = grid.barrier_arrive();
    if ((int)blockIdx.x < items_of(k + 1)) {
      first = begin(k + 1, blockIdx.x);
      bool load = true;
      if constexpr (Gate) {
        const volatile unsigned long long* sl = slots_of(k, first.r);
        load = false;
        for (int j = 0; j < chunks; ++j) {
          int n;
          while ((n = slot_count(sl[j], p.epoch)) < 0) {
          }
          load |= n > 0;
        }
      }
      if (load) {
        load_weights(w, first);
        held = true;
      }
      first_live = load;
    }
    grid.barrier_wait(std::move(token));
  }
}

// one work item per CTA in the layer with the most
template <bool Gate, typename XT, typename WT, int VE>
cudaError_t launch_megakernel(const MegaParams& p, int max_layer_steps,
                              cudaStream_t stream, int* grid) {
  const int chunks = (p.B + kChunkRows - 1) / kChunkRows;
  return launch_cooperative<bsr_megakernel_kernel<Gate, XT, WT, VE>,
                            kThreads>(
      p, max_layer_steps * p.n_slices * chunks,
      4 * mega_smem_words<Gate, VE>(p.k_slice, p.bs, p.n_in / p.bs), stream,
      grid);
}

// The split-K walk's launcher: MegaParams from the block and the call, then
// the instance for the dtypes and the load width.
template <bool Gate>
cudaError_t split_k_walk(const mega::Block& b, const mega::Call& c,
                         int* grid) {
  // the scratch holds the hidden ping-pong buffer, then the partials
  float* partial = c.scratch + (size_t)2 * b.hidden_tiles * c.B * b.bs;
  MegaParams p{c.x,          b.blocks,   b.rows,       b.cols,
               b.run_ptr,    b.step_run, b.part_off,   b.bias_idx,
               b.bias_tiles, b.scales,   c.occ0,       c.slots,
               c.occ,        c.scratch,  partial,      c.arrivals,
               c.out,        c.B,        b.n_in,       b.n_out,
               b.bs,         b.n_layers, b.hidden_tiles, b.k_slice,
               b.n_slices,   b.act,      b.final_act,  c.epoch};
  for (int k = 0; k <= b.n_layers; ++k) p.seg[k] = b.seg[k];
  return with_dtypes(b.x_dtype, b.w_dtype, [&](auto xt, auto wt) {
    using XT = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    auto* go = b.vec != 1 ? &launch_megakernel<Gate, XT, WT, kVec<WT>>
                          : &launch_megakernel<Gate, XT, WT, 1>;
    return go(p, b.max_layer_steps, c.stream, grid);
  });
}

}  // namespace

// Packs a launch block into `block` (`capacity` bytes, at least
// sizeof(mega::Block)): what a flat schedule's launches share, for one walk
// (row_tiled 1: the row-tiled walk, row_tile.cuh; 0: the split-K walk), x
// dtype and width.  x_dtype: 0 float32, 1 bfloat16.  w_dtype: 0 float32,
// 1 bfloat16, 2 float8_e4m3fn.  scales may be null (unit scale).  seg:
// n_layers + 1 host ints (n_layers <= kMaxLayers), copied: on the split-K
// walk each layer's first flat step, then the step count; on the row-tiled
// walk each layer's first entry of run_order (device; every layer's runs
// by live steps, longest first, a patch run r as ~r), then the run count.  The split-K walk reads step_run,
// part_off, k_slice, n_slices, max_layer_steps and vec (weight elements
// per load, 16 bytes' worth or 1); the row-tiled walk reads run_order and
// takes bs 64 or 128 and, for float32 weights, null scales.  A walk ignores
// the other walk's arguments (null or 0 there).  Returns 0 or
// cudaErrorInvalidValue.
extern "C" int bsr_megakernel_prepare(
    void* block, size_t capacity, int row_tiled, int x_dtype, int w_dtype,
    int vec, const void* blocks, const int* rows, const int* cols,
    const int* run_ptr, const int* step_run, const int* part_off,
    const int* run_order, const int* bias_idx, const float* bias_tiles,
    const float* scales, int n_in, int n_out, int bs, int n_layers,
    int hidden_tiles, int k_slice, int n_slices, int max_layer_steps,
    int act, int final_act, const int* seg) {
  if (block == nullptr || capacity < sizeof(mega::Block) || seg == nullptr ||
      n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  // what the walk's kernel instances take
  const bool takes = row_tiled ? (bs == 64 || bs == 128) &&
                                     (w_dtype != 0 || scales == nullptr)
                               : vec_ok(vec, w_dtype);
  if (!takes) return (int)cudaErrorInvalidValue;
  mega::Block b{row_tiled != 0, x_dtype,   w_dtype,   vec,        blocks,
                rows,           cols,      run_ptr,   step_run,   part_off,
                run_order,      bias_idx,  bias_tiles, scales,    n_in,
                n_out,          bs,        n_layers,  hidden_tiles, k_slice,
                n_slices,       max_layer_steps, act, final_act,  {}};
  for (int k = 0; k <= n_layers; ++k) b.seg[k] = seg[k];
  *static_cast<mega::Block*>(block) = b;
  return 0;
}

// One launch from a packed block, with this call's values: x [B, n_in]
// (16-byte aligned on the row-tiled walk), out [B, n_out], the f32 scratch
// (the hidden ping-pong buffer [2, hidden_tiles, B, bs], then on the
// split-K walk the partials [n_steps * n_slices, B, bs]), B >= 1, the
// stream, and the split-K walk's arrival counters [n_runs, chunks] (zero
// between launches).  Gated when occ is not null: then occ0 [grid_in_0] is
// read, slots [max(1, n_layers-1), hidden_tiles, chunks] (8 bytes each,
// zero at first, kept between launches with one layout) is written with
// `epoch`, which is not 0 and differs from the epochs of the earlier
// launches on them, and occ [max(1, n_layers-1), hidden_tiles] is written
// in full.  A launch reads the block and never writes it, so threads may
// share one.  Returns the cooperative grid size (at least 1), or minus the
// CUDA error.
extern "C" int bsr_megakernel_prepared_launch(
    const void* block, const void* x, void* out, float* scratch, int B,
    void* stream, int* arrivals, const int* occ0, void* slots, int* occ,
    unsigned epoch) {
  const mega::Block& b = *static_cast<const mega::Block*>(block);
  const bool gate = occ != nullptr;
  if (B < 1 || (gate && (occ0 == nullptr || slots == nullptr || epoch == 0)) ||
      (b.row_tiled && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return -(int)cudaErrorInvalidValue;
  const mega::Call c{x,        out,  scratch,
                     B,        static_cast<cudaStream_t>(stream),
                     arrivals, occ0, static_cast<unsigned long long*>(slots),
                     occ,      epoch};
  int grid = 0;
  cudaError_t err;
  if (b.row_tiled)
    err = (gate ? mega::row_tiled_gated : mega::row_tiled)(b, c, &grid);
  else
    err = gate ? split_k_walk<true>(b, c, &grid)
               : split_k_walk<false>(b, c, &grid);
  return err != cudaSuccess ? -(int)err : grid;
}
