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
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the launch API's own error).  Launches of one flat
// schedule must be ordered on one stream: they share the arrival counters
// and the occupancy slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <utility>

#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 32;  // the segment table travels by value

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

// the count of a slot this launch wrote, or -1 for a stale one
__device__ __forceinline__ int slot_count(unsigned long long v,
                                          unsigned epoch) {
  return (unsigned)(v >> 32) == epoch ? (int)(unsigned)v : -1;
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
      if (is_final && blockIdx.x == gridDim.x - 1) {
        // every hidden layer's slots are final: the returned occupancy
        const int n_occ = max(1, p.n_layers - 1);
        for (int e = threadIdx.x; e < n_occ * p.hidden_tiles;
             e += kThreads) {
          int sum = 0;  // 0 for tiles no layer writes in this launch
          for (int j = 0; j < chunks; ++j)
            sum += max(0, slot_count(__ldcg(p.slots + (size_t)e * chunks + j),
                                     p.epoch));
          p.occ[e] = sum;
        }
      }
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

constexpr int kMaxDevices = 16;

// The co-resident CTA count of one kernel instance at one dynamic
// shared-memory size, and its shared-memory attribute, set and queried once
// per device rather than on every call.
template <bool Gate, typename XT, typename WT, int VE>
cudaError_t coresident_ctas(size_t smem, int* ctas) {
  struct Cap {
    size_t smem;
    int ctas;
  };
  static std::mutex mu;
  static Cap cap[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Cap* c = dev < kMaxDevices ? &cap[dev] : nullptr;
  if (c != nullptr && c->ctas > 0 && c->smem == smem) {
    *ctas = c->ctas;
    return cudaSuccess;
  }
  auto kernel = bsr_megakernel_kernel<Gate, XT, WT, VE>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas = per_sm * sms;
  if (c != nullptr) *c = Cap{smem, *ctas};
  return cudaSuccess;
}

template <bool Gate, typename XT, typename WT, int VE>
cudaError_t launch_megakernel(MegaParams p, int max_layer_steps,
                              cudaStream_t stream, int* grid_used) {
  const size_t smem =
      4 * mega_smem_words<Gate, VE>(p.k_slice, p.bs, p.n_in / p.bs);
  int ctas = 0;
  cudaError_t err = coresident_ctas<Gate, XT, WT, VE>(smem, &ctas);
  if (err != cudaSuccess) return err;
  const int chunks = (p.B + kChunkRows - 1) / kChunkRows;
  int grid = max_layer_steps * p.n_slices * chunks;
  if (grid > ctas) grid = ctas;  // all CTAs co-resident
  if (grid < 1) grid = 1;
  if (grid_used != nullptr) *grid_used = grid;
  auto kernel = bsr_megakernel_kernel<Gate, XT, WT, VE>;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool Gate>
int megakernel_dispatch(int x_dtype, int w_dtype, bool vec,
                        const MegaParams& p, int max_layer_steps,
                        cudaStream_t s, int* grid) {
#define BSR_MEGA(XT, WT, VE) \
  return (int)launch_megakernel<Gate, XT, WT, VE>(p, max_layer_steps, s, grid)
  switch (x_dtype * 3 + w_dtype) {
    case 0: if (vec) BSR_MEGA(float, float, 4); BSR_MEGA(float, float, 1);
    case 1:
      if (vec) BSR_MEGA(float, __nv_bfloat16, 8);
      BSR_MEGA(float, __nv_bfloat16, 1);
    case 2:
      if (vec) BSR_MEGA(float, __nv_fp8_e4m3, 16);
      BSR_MEGA(float, __nv_fp8_e4m3, 1);
    case 3:
      if (vec) BSR_MEGA(__nv_bfloat16, float, 4);
      BSR_MEGA(__nv_bfloat16, float, 1);
    case 4:
      if (vec) BSR_MEGA(__nv_bfloat16, __nv_bfloat16, 8);
      BSR_MEGA(__nv_bfloat16, __nv_bfloat16, 1);
    case 5:
      if (vec) BSR_MEGA(__nv_bfloat16, __nv_fp8_e4m3, 16);
      BSR_MEGA(__nv_bfloat16, __nv_fp8_e4m3, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BSR_MEGA
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16.  w_dtype: 0 float32, 1 bfloat16,
// 2 float8_e4m3fn.  vec: weight elements per load, 16 bytes' worth or 1.
// scales may be null (unit scale).  Gated when occ is not null: then occ0
// [grid_in_0] is read, slots [max(1, n_layers-1), hidden_tiles, chunks]
// (8 bytes each, zero at first, kept between launches with one layout) is
// written with `epoch`, which is not 0 and differs from the epochs of the
// earlier launches on them, and occ [max(1, n_layers-1), hidden_tiles] is
// written in full.  seg: the first flat step of every layer, then the step
// count (n_layers + 1 host ints, n_layers <= kMaxLayers).  grid, when not
// null, receives the cooperative grid size.
extern "C" int bsr_megakernel_launch(
    int x_dtype, int w_dtype, int vec, const void* x, const void* blocks,
    const int* rows, const int* cols, const int* run_ptr,
    const int* step_run, const int* part_off, const int* bias_idx,
    const float* bias_tiles, const float* scales, const int* occ0,
    void* slots, int* occ, float* hidden, float* partial, int* arrivals,
    void* out, int B, int n_in, int n_out, int bs, int n_layers,
    int hidden_tiles, int k_slice, int n_slices, int max_layer_steps,
    int act, int final_act, unsigned epoch, const int* seg, void* stream,
    int* grid) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec * (w_dtype == 0 ? 4 : w_dtype == 1 ? 2 : 1) != 16)
    return (int)cudaErrorInvalidValue;
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  MegaParams p{x,          blocks,     rows,      cols,
               run_ptr,    step_run,   part_off,  bias_idx,
               bias_tiles, scales,     occ0,
               static_cast<unsigned long long*>(slots),
               occ,        hidden,     partial,   arrivals,
               out,        B,          n_in,      n_out,
               bs,         n_layers,   hidden_tiles, k_slice,
               n_slices,   act,        final_act, epoch};
  for (int k = 0; k <= n_layers; ++k) p.seg[k] = seg[k];
  if (occ != nullptr) {
    if (occ0 == nullptr || slots == nullptr || epoch == 0)
      return (int)cudaErrorInvalidValue;
    return megakernel_dispatch<true>(x_dtype, w_dtype, vec != 1, p,
                                     max_layer_steps, s, grid);
  }
  return megakernel_dispatch<false>(x_dtype, w_dtype, vec != 1, p,
                                    max_layer_steps, s, grid);
}

// The prepared launch.  What a flat schedule's launches share (its tensors,
// sizes, split-K constants, epilogues and layer table) is packed once per
// schedule, walk, x dtype and width into a launch block, in memory the
// caller owns and keeps (bsr_megakernel_prepare); each call then passes
// only its own values (bsr_megakernel_prepared_launch): 11 arguments where
// the walks' entries take 28 and 35, since the host pays for a ctypes call
// by the argument.  A launch reads the block and never writes it, so
// threads may share one.

// bsr_row_tiled.cu, bsr_row_tiled_gated.cu (row_tile.cuh's
// BSR_ROW_TILED_ARGS)
extern "C" int bsr_megakernel_row_tiled_launch(
    int x_dtype, int w_dtype, const void* x, const void* blocks,
    const int* rows, const int* cols, const int* run_ptr,
    const int* run_order, const int* bias_idx, const float* bias_tiles,
    const float* scales, const int* occ0, void* slots, int* occ,
    float* hidden, void* out, int B, int n_in, int n_out, int bs,
    int n_layers, int hidden_tiles, int act, int final_act, unsigned epoch,
    const int* run_seg, void* stream, int* grid);
extern "C" int bsr_megakernel_row_tiled_gated_launch(
    int x_dtype, int w_dtype, const void* x, const void* blocks,
    const int* rows, const int* cols, const int* run_ptr,
    const int* run_order, const int* bias_idx, const float* bias_tiles,
    const float* scales, const int* occ0, void* slots, int* occ,
    float* hidden, void* out, int B, int n_in, int n_out, int bs,
    int n_layers, int hidden_tiles, int act, int final_act, unsigned epoch,
    const int* run_seg, void* stream, int* grid);

namespace {

struct MegaBlock {
  int row_tiled;  // the walk: 1 row-tiled, 0 split-K
  int x_dtype, w_dtype, vec;
  const void* blocks;
  const int *rows, *cols, *run_ptr;
  const int *step_run, *part_off;  // split-K
  const int* run_order;            // row-tiled
  const int* bias_idx;
  const float *bias_tiles, *scales;
  int n_in, n_out, bs, n_layers, hidden_tiles;
  int k_slice, n_slices, max_layer_steps;  // split-K
  int act, final_act;
  // split-K: each layer's first flat step, then the step count (seg);
  // row-tiled: each layer's first entry of run_order, then the run count
  // (run_seg)
  int seg[kMaxLayers + 1];
};

}  // namespace

// Packs a launch block into `block` (`capacity` bytes, at least
// sizeof(MegaBlock)): the arguments of bsr_megakernel_launch (row_tiled 0)
// or of the row-tiled entries (row_tiled 1) that do not change between a
// schedule's calls; the walk ignores the others (null or 0 there).  seg:
// n_layers + 1 host ints, copied.  Returns 0 or cudaErrorInvalidValue.
extern "C" int bsr_megakernel_prepare(
    void* block, size_t capacity, int row_tiled, int x_dtype, int w_dtype,
    int vec, const void* blocks, const int* rows, const int* cols,
    const int* run_ptr, const int* step_run, const int* part_off,
    const int* run_order, const int* bias_idx, const float* bias_tiles,
    const float* scales, int n_in, int n_out, int bs, int n_layers,
    int hidden_tiles, int k_slice, int n_slices, int max_layer_steps,
    int act, int final_act, const int* seg) {
  if (block == nullptr || capacity < sizeof(MegaBlock) || seg == nullptr ||
      n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  MegaBlock b{row_tiled != 0, x_dtype,   w_dtype,   vec,        blocks,
              rows,           cols,      run_ptr,   step_run,   part_off,
              run_order,      bias_idx,  bias_tiles, scales,    n_in,
              n_out,          bs,        n_layers,  hidden_tiles, k_slice,
              n_slices,       max_layer_steps, act, final_act,  {}};
  for (int k = 0; k <= n_layers; ++k) b.seg[k] = seg[k];
  *static_cast<MegaBlock*>(block) = b;
  return 0;
}

// One launch from a packed block, with this call's values: x, out, the
// f32 scratch (the hidden ping-pong buffer [2, hidden_tiles, B, bs], then
// on the split-K walk the partials), B, the stream, the split-K walk's
// arrival counters, and, gated (occ not null), occ0, slots, occ and epoch,
// as bsr_megakernel_launch takes them.  Returns the cooperative grid size
// (at least 1), or minus the CUDA error.
extern "C" int bsr_megakernel_prepared_launch(
    const void* block, const void* x, void* out, float* scratch, int B,
    void* stream, int* arrivals, const int* occ0, void* slots, int* occ,
    unsigned epoch) {
  const MegaBlock& b = *static_cast<const MegaBlock*>(block);
  int grid = 0;
  int rc;
  if (b.row_tiled) {
    rc = (occ != nullptr ? bsr_megakernel_row_tiled_gated_launch
                         : bsr_megakernel_row_tiled_launch)(
        b.x_dtype, b.w_dtype, x, b.blocks, b.rows, b.cols, b.run_ptr,
        b.run_order, b.bias_idx, b.bias_tiles, b.scales, occ0, slots, occ,
        scratch, out, B, b.n_in, b.n_out, b.bs, b.n_layers, b.hidden_tiles,
        b.act, b.final_act, epoch, b.seg, stream, &grid);
  } else {
    float* partial = scratch + (size_t)2 * b.hidden_tiles * B * b.bs;
    rc = bsr_megakernel_launch(
        b.x_dtype, b.w_dtype, b.vec, x, b.blocks, b.rows, b.cols, b.run_ptr,
        b.step_run, b.part_off, b.bias_idx, b.bias_tiles, b.scales, occ0,
        slots, occ, scratch, partial, arrivals, out, B, b.n_in, b.n_out,
        b.bs, b.n_layers, b.hidden_tiles, b.k_slice, b.n_slices,
        b.max_layer_steps, b.act, b.final_act, epoch, b.seg, stream, &grid);
  }
  return rc != 0 ? -rc : grid;
}
