// Hand-written Hopper (sm_90a) megakernel, its row-tiled route: the whole
// scheduled block-sparse net in one launch, for large batches.  Its two
// launchers, mega::row_tiled and mega::row_tiled_gated (mega.cuh), compile
// in two units, so that nvcc builds them side by side: bsr_row_tiled.cu
// (ungated) and bsr_row_tiled_gated.cu (Gate = true).  Both launch from the
// megakernel's launch block, which bsr_kernels.cu's C entries check.
//
// bsr_megakernel (kernels/bsr_matmul.py) launches one of two kernels for
// the Pallas kernel bsr_megakernel (src/repro/kernels/bsr_matmul.py,
// `bsr_megakernel` / body `_megakernel`, gated with gate=True): the split-K
// walk of bsr_kernels.cu, made for serving batches (B <= 32), or this one,
// whose work items need no split of K because a batch's rows alone fill
// the card.  bsr_matmul.row_tiled(B, flat) chooses, from the batch and the
// schedule alone: B > 32 and at least 16 items (runs x 64-row tiles) in
// every layer, so both benchmark nets (8 runs in their narrowest layers)
// cross over at B = 65.  A sweep of B on the H100 (PERF.md) found the
// row-tiled walk faster from B = 96 on at the BERT net (85 us against
// 92; at B = 80, 86 against 78) and at every B from 32 on at the MLP (33
// us against 60).
//
// What bounds it on the H100.  At B = 4,096 rows a forward of the paper's
// BERT-large FFNN (1024 -> 4096 -> 1024, density 0.1, 128 x 128 tiles; 66
// scheduled blocks at the benchmark's layout, of which this walk multiplies
// the 52 kept ones and none of the 14 patch blocks) is 7.0 GFLOP of f32
// FMA, 104 us at 67 TFLOP/s, while its bytes (x, y, the hidden activations
// once each, the weights) take 30 us at 3.35 TB/s: the FMA rate bounds it.  The split-K walk, at this batch, re-read every
// weight slice once per 32-row chunk, wrote and read back ~0.55 GB of f32
// partials through HBM, and reduced four row groups through shared memory
// behind two barriers per 8-row pass: 2.9 ms a call.
//
// Design.  A work item is (layer k, output-tile run, row tile of kRowBM =
// 64 batch rows).  One CTA of 256 threads, a 16 x 16 grid, owns the item's
// [64, bs] output tile as f32 accumulators in registers: thread (ty, tx)
// holds rows ty + 16 i (i < 4) and the 4-column groups tx + 16 q
// (q < bs / 64), a 4 x 8 tile at bs = 128.  It walks the run's steps in
// schedule order, each block in stages of kRowBK = 64 K-rows:
//   1. a stage is copied into one of kRowStages = 2 shared-memory buffers
//      by 16-byte cp.async.cg copies (through L2, since other CTAs of the
//      launch wrote the hidden tiles), in the inputs' own dtypes: the x
//      tile [64, 64] row by row (rows past B zero-filled) and the weight
//      tile [64, bs], which is contiguous in the block; the next stage's
//      copies fly while this one is multiplied;
//   2. rt_fma_stage reads, for every 4 K-rows, each of its rows' 4 inputs
//      with one vector load and, for every K-row, its 4-column weight
//      groups with one vector load each, widens both to f32 (the weights
//      times the step's scale) on the way into registers, and adds the
//      products to its accumulators: plain f32 FMA, no tensor cores, no
//      TF32;
//   3. at the item's last stage, the epilogue adds the bias, applies the
//      activation and writes the hidden tile (f32, through L2) or the
//      output (x's dtype).
// So each output is one f32 FMA chain in (step, K-row) order from +0: no
// partials, no arrival counters, no atomics, the same bits on every
// launch.  The stages of all of a CTA's items in a layer form one stream,
// so the next item's first copies fly while this one finishes.  The
// split-K walk sums the same products in another order, so with f32 x the
// row-tiled output is not bit-equal to two bsr_matmul launches (the
// split-K walk's is); both are within the f32 tolerance of the plain
// version.  On the H100 (PERF.md): 64-row tiles and 64-deep stages in two
// buffers beat 128-row tiles (whose 8 x 8 register tile spills at two CTAs
// per SM, or runs one CTA per SM), 16- and 32-deep stages, deeper rings,
// three CTAs per SM and a warp layout of 8 x 4 threads.
//
// Patch runs.  ops.compile_schedule gives an output tile with no kept
// block a patch block, a zero block, so that the split-K walk writes its
// act(bias).  This walk multiplies none: the host flags each patch run in
// run_order (as ~run, RowRuns.walk_order), and its items take the one empty
// stage of an item with no live step, whose epilogue writes act(+0 + bias),
// the bits the zero block's products would give for finite inputs.  So the
// row-tiled walk's work follows the kept blocks alone: 52 of the BERT
// net's 66 steps and 24 of the MLP's 38.
//
// Balance.  A layer's items are its runs by live steps, longest first
// (patch runs last), each cut into row tiles; CTA j of G takes items j,
// 2G - 1 - j, 2G + j, ...: forward in even rounds, backward in odd ones,
// so that the CTAs that drew the longest items draw the shortest next, and
// the epilogue-only patch items fall to the CTAs that would otherwise wait
// at the barrier.  At the BERT net and 4,096 rows the busiest CTA then
// holds 8 live steps of layer 0 (mean 6.3) and 7 of layer 1 (mean 6.3).
//
// Layers are separated by a grid-wide barrier, split as in the split-K
// walk: between its arrival and its wait an ungated CTA issues the weight
// copies of its first stage of the next layer, which do not depend on
// this layer.
//
// Gating (Gate = true), with the split-K walk's occupancy slots and epoch:
// at a layer's start each CTA reads which input tiles are live (x's from
// occ0; a hidden tile's from its chunk slots of this launch's epoch) and
// drops the dead steps from its walk, so their weights are never read.
// The result is bit-equal to the ungated one: a dead tile holds only +-0
// in every valid row, so fmaf(+-0, w, acc) leaves an acc != 0 as it is and
// gives +0 for acc = +0, and the chain, which starts at +0, is never -0.
// An item whose steps are all dead writes act(bias).  Its epilogue counts
// the rows with a nonzero per 32-row chunk into the slots; the last CTA
// writes occ after the last barrier.  A gated CTA issues nothing across
// the barrier: whether its first weights are read depends on the layer.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the launch API's own error).  Launches of one flat
// schedule must be ordered on one stream: they share the occupancy slots.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>
#include <utility>

#include "mega.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowThreads = 256;   // a 16 x 16 grid
constexpr int kRowBM = 64;         // batch rows of an item
constexpr int kRowTM = kRowBM / 16;  // of them, a thread's
constexpr int kRowBK = 64;         // K-rows of a block per stage
constexpr int kRowStages = 2;      // the cp.async buffers

// a staged x row in elements: kRowBK and 16 bytes of padding, so that the
// rows a warp reads at once fall in different banks
template <typename T>
__host__ __device__ constexpr int row_xs() {
  return kRowBK + 16 / (int)sizeof(T);
}
// the x part of a stage, sized for f32 (the hidden layers' input)
constexpr int kRowXBytes = kRowBM * row_xs<float>() * 4;

// one stage: x tile, then weight tile
template <typename WT, int BS>
__host__ __device__ constexpr int row_stage_bytes() {
  return kRowXBytes + kRowBK * BS * (int)sizeof(WT);
}

__device__ __forceinline__ void rt_cp_async16(void* dst, const void* src,
                                              bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void rt_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void rt_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the weight tile of a stage: kRowBK contiguous block rows
template <typename WT, int BS>
__device__ __forceinline__ void rt_issue_w(unsigned char* dst,
                                           const WT* src) {
  constexpr int kPieces = kRowBK * BS * (int)sizeof(WT) / 16;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  for (int c = threadIdx.x; c < kPieces; c += kRowThreads)
    rt_cp_async16(dst + 16 * c, s + 16 * c, true);
}

// the x tile of a stage: rows 0 .. kRowBM-1 of src (rows `stride` elements
// apart), kRowBK elements each; rows from nrows on are zero-filled
template <typename T>
__device__ __forceinline__ void rt_issue_x(unsigned char* dst, const T* src,
                                           size_t stride, int nrows) {
  constexpr int kPer = kRowBK * (int)sizeof(T) / 16;  // pieces of a row
  constexpr int kE = 16 / (int)sizeof(T);             // elements of a piece
  T* d = reinterpret_cast<T*>(dst);
  for (int c = threadIdx.x; c < kRowBM * kPer; c += kRowThreads) {
    const int i = c / kPer;
    const int q = c - i * kPer;
    const bool ok = i < nrows;
    rt_cp_async16(d + i * row_xs<T>() + q * kE,
                  ok ? src + (size_t)i * stride + q * kE : src, ok);
  }
}

// 4 neighbouring staged values widened to f32 (weights also scaled; f32
// weights carry no scale: ops.quantize_blocks keeps none for them)
__device__ __forceinline__ void rt_load4(float* v, const float* p, float) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void rt_load4(float* v, const __nv_bfloat16* p,
                                         float s) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16) * s;
  v[1] = __uint_as_float(u.x & 0xffff0000u) * s;
  v[2] = __uint_as_float(u.y << 16) * s;
  v[3] = __uint_as_float(u.y & 0xffff0000u) * s;
}
__device__ __forceinline__ void rt_load4(float* v, const __nv_fp8_e4m3* p,
                                         float s) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>((u >> (8 * j)) & 0xffu), __NV_E4M3);
    v[j] = __half2float(__half(h)) * s;
  }
}

// one stage's products into the thread's [kRowTM][TN] accumulators: xs is
// the staged x tile (rows row_xs<IT>() apart), ws the staged weight tile
// (rows 16 * TN = bs apart)
template <typename IT, typename WT, int TN>
__device__ __forceinline__ void rt_fma_stage(float (&acc)[kRowTM][TN],
                                             const IT* xs, const WT* ws,
                                             float sc, int ty, int tx) {
  constexpr int XS = row_xs<IT>();
  constexpr int BS = 16 * TN;
#pragma unroll 4
  for (int kq = 0; kq < kRowBK; kq += 4) {
    float xv[kRowTM][4];
#pragma unroll
    for (int i = 0; i < kRowTM; ++i)
      rt_load4(xv[i], xs + (ty + 16 * i) * XS + kq, 1.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        rt_load4(wv + 4 * q, ws + (kq + kk) * BS + 4 * (tx + 16 * q), sc);
#pragma unroll
      for (int i = 0; i < kRowTM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(xv[i][kk], wv[j], acc[i][j]);
      }
    }
  }
}

// 4 neighbouring outputs in the output's dtype
__device__ __forceinline__ void rt_store4(float* p, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void rt_store4(__nv_bfloat16* p, float a, float b,
                                          float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

struct RowParams {
  const void* x;            // [B, n_in], XT, 16-byte aligned
  const void* blocks;       // [n_steps, bs, bs], WT, schedule order
  const int* rows;          // [n_steps] layer-local input tile
  const int* cols;          // [n_steps] layer-local output tile
  const int* run_ptr;       // [n_runs + 1] first step of every run
  // [n_runs] every layer's runs by live steps, longest first; a patch run
  // r (no live step) as ~r, last
  const int* run_order;
  const int* bias_idx;      // [n_steps] row of bias_tiles
  const float* bias_tiles;  // [sum of grid_out, bs]
  const float* scales;      // [n_steps] dequant factors (not for f32), or null
  const int* occ0;          // Gate: [grid_in_0]
  // Gate: [max(1, n_layers-1), hidden_tiles, chunks], (epoch << 32) | count
  unsigned long long* slots;
  int* occ;                 // Gate: [max(1, n_layers-1), hidden_tiles]
  float* hidden;            // [2, hidden_tiles, B, bs]
  void* out;                // [B, n_out], XT
  int B, n_in, n_out, n_layers, hidden_tiles, act, final_act;
  unsigned epoch;           // Gate: this launch's tag on the slots, not 0
  int run_seg[kMaxLayers + 1];  // each layer's first entry of run_order
};

// Where a CTA's walk of one layer stands: its n-th item (run, row tile
// from b0) and, in it, step g's K-rows k0 .. k0 + kRowBK - 1.  g < 0 marks
// the one empty stage of an item with no live step (a patch run's, or one
// whose steps are all dead, gated), which still writes act(bias).
struct RowCursor {
  int n, run, b0, g, g1, k0;
  bool done;
};

// A layer's items and how a CTA visits them: item i is row tile i % nt of
// run run_order[run0 + i / nt]; CTA j of G takes items j, 2G - 1 - j,
// 2G + j, ...  live (gated): whether each input tile of the layer holds a
// nonzero.
template <bool Gate, int BS>
struct RowWalk {
  const int* rows;
  const int* run_ptr;
  const int* run_order;
  const int* live;
  int nt, n_items, run0;

  __device__ RowWalk(const RowParams& p, int k, const int* live_tiles)
      : rows(p.rows),
        run_ptr(p.run_ptr),
        run_order(p.run_order),
        live(live_tiles),
        nt((p.B + kRowBM - 1) / kRowBM),
        n_items((p.run_seg[k + 1] - p.run_seg[k]) * nt),
        run0(p.run_seg[k]) {}

  __device__ bool step_live(int g) const {
    return !Gate || live[__ldg(rows + g)] != 0;
  }
  __device__ int next_live(int g, int g1) const {
    while (g < g1 && !step_live(g)) ++g;
    return g;
  }
  // c at the CTA's n-th item or, past the layer's end, later; done when
  // no item is left
  __device__ void enter(RowCursor& c, int n) const {
    const int G = gridDim.x;
    const int j = blockIdx.x;
    for (;; ++n) {
      if ((long long)n * G >= n_items) {
        c.done = true;
        return;
      }
      const int i = n * G + ((n & 1) ? G - 1 - j : j);
      if (i >= n_items) continue;
      const int q = i / nt;
      const int r = __ldg(run_order + run0 + q);
      c.n = n;
      c.done = false;
      c.run = r < 0 ? ~r : r;
      c.b0 = (i - q * nt) * kRowBM;
      c.g1 = __ldg(run_ptr + c.run + 1);
      c.g = r < 0 ? c.g1 : next_live(__ldg(run_ptr + c.run), c.g1);
      if (c.g == c.g1) c.g = -1;
      c.k0 = 0;
      return;
    }
  }
  // c's stage is its item's last
  __device__ bool last(const RowCursor& c) const {
    return c.g < 0 ||
           (c.k0 + kRowBK >= BS && next_live(c.g + 1, c.g1) == c.g1);
  }
  __device__ void advance(RowCursor& c) const {
    if (c.g >= 0) {
      c.k0 += kRowBK;
      if (c.k0 < BS) return;
      c.k0 = 0;
      c.g = next_live(c.g + 1, c.g1);
      if (c.g < c.g1) return;
    }
    enter(c, c.n + 1);
  }
};

// Gate: whether each input tile of layer k holds a nonzero in a valid row
// (x's from occ0; a hidden tile's from any of its chunk slots)
template <int BS>
__device__ __forceinline__ void row_live(const RowParams& p, int k,
                                         int* live) {
  if (k == 0) {
    for (int t = threadIdx.x; t < p.n_in / BS; t += kRowThreads)
      live[t] = __ldg(p.occ0 + t) > 0;
  } else {
    for (int t = threadIdx.x; t < p.hidden_tiles; t += kRowThreads)
      live[t] = 0;
    __syncthreads();
    const int chunks = (p.B + kChunkRows - 1) / kChunkRows;
    const unsigned long long* sl =
        p.slots + (size_t)(k - 1) * p.hidden_tiles * chunks;
    for (int e = threadIdx.x; e < p.hidden_tiles * chunks; e += kRowThreads)
      if (slot_count(__ldcg(sl + e), p.epoch) > 0) live[e / chunks] = 1;
  }
  __syncthreads();
}

// per warp, the rows of an item with a nonzero, per 32-row chunk
using NzWords = unsigned[kRowThreads / 32][kRowBM / kChunkRows];

// The end of an item: bias and epilogue on the thread's outputs, written
// as the hidden tile (f32, through L2) or the output (x's dtype); gated,
// the count of the item's rows with a nonzero, per 32-row chunk, into the
// slots as the split-K reducers write them.
template <bool Gate, typename XT, int TN>
__device__ __forceinline__ void row_epilogue(const RowParams& p, int k,
                                             const RowCursor& c,
                                             const float (&acc)[kRowTM][TN],
                                             NzWords& nz_words) {
  constexpr int BS = 16 * TN;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int B = p.B;
  const bool is_final = k == p.n_layers - 1;
  const int act = is_final ? p.final_act : p.act;
  const int g0 = __ldg(p.run_ptr + c.run);
  const int ct = __ldg(p.cols + g0);
  const float* bias = p.bias_tiles + (size_t)__ldg(p.bias_idx + g0) * BS;
  float* h_out = p.hidden + (size_t)(k % 2) * p.hidden_tiles * B * BS;
  const int nrows = min(kRowBM, B - c.b0);
  // Gate: row ty + 16 i is bit ty + 16 (i % 2) of chunk i / 2
  unsigned nz[kRowBM / kChunkRows] = {};
#pragma unroll
  for (int i = 0; i < kRowTM; ++i) {
    const int row = ty + 16 * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int col = 4 * (tx + 16 * q);
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
      const float v0 = activate(acc[i][4 * q] + b.x, act);
      const float v1 = activate(acc[i][4 * q + 1] + b.y, act);
      const float v2 = activate(acc[i][4 * q + 2] + b.z, act);
      const float v3 = activate(acc[i][4 * q + 3] + b.w, act);
      if (is_final) {
        rt_store4(static_cast<XT*>(p.out) + (size_t)(c.b0 + row) * p.n_out +
                      (size_t)ct * BS + col,
                  v0, v1, v2, v3);
      } else {
        __stcg(reinterpret_cast<float4*>(
                   h_out + ((size_t)ct * B + c.b0 + row) * BS + col),
               make_float4(v0, v1, v2, v3));
        if (Gate && (v0 != 0.f || v1 != 0.f || v2 != 0.f || v3 != 0.f))
          nz[i / 2] |= 1u << (ty + 16 * (i & 1));
      }
    }
  }
  if constexpr (Gate) {
    if (is_final) return;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < kRowBM / kChunkRows; ++q) {
      const unsigned m = __reduce_or_sync(0xffffffffu, nz[q]);
      if ((threadIdx.x & 31) == 0) nz_words[warp][q] = m;
    }
    __syncthreads();
    if ((int)threadIdx.x < (nrows + kChunkRows - 1) / kChunkRows) {
      unsigned m = 0;
      for (int w = 0; w < kRowThreads / 32; ++w) m |= nz_words[w][threadIdx.x];
      const int chunks = (B + kChunkRows - 1) / kChunkRows;
      p.slots[((size_t)k * p.hidden_tiles + ct) * chunks +
              c.b0 / kChunkRows + threadIdx.x] =
          (unsigned long long)p.epoch << 32 | __popc(m);
    }
  }
}

// Layer k of the walk; IT is the type of its input (x's in layer 0, f32
// after).  w_issued: the weights of the CTA's first stage are in flight
// already (issued across the barrier).
template <bool Gate, typename XT, typename WT, int BS, typename IT>
__device__ __forceinline__ void row_layer(const RowParams& p, int k,
                                          unsigned char* ring,
                                          const int* live, NzWords& nz_words,
                                          bool w_issued) {
  constexpr int TN = BS / 16;
  constexpr int SB = row_stage_bytes<WT, BS>();
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int B = p.B;
  // the layer's input: tile r's rows from b0 lie at src + r * tile_stride
  // + b0 * row_stride (x in layer 0, the f32 hidden buffer after)
  const IT* src;
  size_t tile_stride, row_stride;
  if (k == 0) {
    src = static_cast<const IT*>(p.x);
    tile_stride = BS;
    row_stride = p.n_in;
  } else {
    src = reinterpret_cast<const IT*>(
        p.hidden + (size_t)((k + 1) % 2) * p.hidden_tiles * B * BS);
    tile_stride = (size_t)B * BS;
    row_stride = BS;
  }
  const WT* blocks = static_cast<const WT*>(p.blocks);
  const RowWalk<Gate, BS> W(p, k, live);
  auto issue = [&](const RowCursor& c, int s, bool weights) {
    if (c.g < 0) return;
    unsigned char* st = ring + s * SB;
    if (weights)
      rt_issue_w<WT, BS>(st + kRowXBytes,
                         blocks + ((size_t)c.g * BS + c.k0) * BS);
    rt_issue_x<IT>(st,
                   src + (size_t)__ldg(p.rows + c.g) * tile_stride +
                       (size_t)c.b0 * row_stride + c.k0,
                   row_stride, min(kRowBM, B - c.b0));
  };
  RowCursor ic, cc;  // the stage to issue next, the stage to compute next
  W.enter(ic, 0);
  cc = ic;
  for (int s = 0; s < kRowStages - 1; ++s) {
    if (!ic.done) {
      issue(ic, s, !(s == 0 && w_issued));
      W.advance(ic);
    }
    rt_commit();
  }
  float acc[kRowTM][TN] = {};
  for (int s = 0; !cc.done; s = s == kRowStages - 1 ? 0 : s + 1) {
    rt_wait<kRowStages - 2>();
    __syncthreads();  // stage s landed; every thread is done with s - 1
    if (!ic.done) {
      issue(ic, s == 0 ? kRowStages - 1 : s - 1, true);
      W.advance(ic);
    }
    rt_commit();
    if (cc.g >= 0) {
      const unsigned char* st = ring + s * SB;
      const float sc = p.scales != nullptr ? __ldg(p.scales + cc.g) : 1.f;
      rt_fma_stage<IT, WT, TN>(acc, reinterpret_cast<const IT*>(st),
                               reinterpret_cast<const WT*>(st + kRowXBytes),
                               sc, ty, tx);
    }
    if (W.last(cc)) {
      row_epilogue<Gate, XT>(p, k, cc, acc, nz_words);
#pragma unroll
      for (int i = 0; i < kRowTM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      }
    }
    W.advance(cc);
  }
  rt_wait<0>();
}

// The row-tiled route: layer by layer in one cooperative launch, as the
// split-K walk, a grid-wide barrier between the layers.
template <bool Gate, typename XT, typename WT, int BS>
__global__ void __launch_bounds__(kRowThreads, 2)
    bsr_megakernel_row_tiled_kernel(const __grid_constant__ RowParams p) {
  static_assert(BS % kRowBK == 0 && BS % 64 == 0, "64 or 128 wide blocks");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ NzWords nz_words;  // Gate
  cg::grid_group grid = cg::this_grid();
  // Gate: the liveness of the current layer's input tiles, after the ring
  int* live = reinterpret_cast<int*>(ring +
                                     kRowStages * row_stage_bytes<WT, BS>());
  bool w_issued = false;
  for (int k = 0; k < p.n_layers; ++k) {
    const bool is_final = k == p.n_layers - 1;
    if constexpr (Gate) {
      row_live<BS>(p, k, live);
      if (is_final && blockIdx.x == gridDim.x - 1)
        sum_occupancy<kRowThreads>(p, (p.B + kChunkRows - 1) / kChunkRows);
    }
    if constexpr (std::is_same<XT, float>::value) {
      row_layer<Gate, XT, WT, BS, float>(p, k, ring, live, nz_words,
                                         w_issued);
    } else if (k == 0) {
      row_layer<Gate, XT, WT, BS, XT>(p, k, ring, live, nz_words, w_issued);
    } else {
      row_layer<Gate, XT, WT, BS, float>(p, k, ring, live, nz_words,
                                         w_issued);
    }
    if (is_final) break;
    // layer k's hidden tiles (and slots) are complete once the barrier is
    // passed; between its arrival and its wait, an ungated CTA issues the
    // weights of its first stage of layer k + 1, unless that item is a
    // patch run's, which has no stage
    __syncthreads();  // every thread is done with the buffers
    cg::grid_group::arrival_token token = grid.barrier_arrive();
    if constexpr (!Gate) {
      const RowWalk<false, BS> W(p, k + 1, nullptr);
      RowCursor c;
      W.enter(c, 0);
      w_issued = !c.done && c.g >= 0;
      if (w_issued)
        rt_issue_w<WT, BS>(ring + kRowXBytes,
                           static_cast<const WT*>(p.blocks) +
                               (size_t)c.g * BS * BS);
    }
    grid.barrier_wait(std::move(token));
  }
}

template <bool Gate, typename XT, typename WT, int BS>
cudaError_t launch_row_tiled(const RowParams& p, cudaStream_t stream,
                             int* grid) {
  // the buffers, then (gated) one int per input tile of any layer
  const size_t smem =
      (size_t)kRowStages * row_stage_bytes<WT, BS>() +
      (Gate ? 4 * (size_t)max(p.n_in / BS, p.hidden_tiles) : 0);
  int items = 0;  // of the layer with the most
  for (int k = 0; k < p.n_layers; ++k)
    items = max(items, (p.run_seg[k + 1] - p.run_seg[k]) *
                           ((p.B + kRowBM - 1) / kRowBM));
  return launch_cooperative<bsr_megakernel_row_tiled_kernel<Gate, XT, WT, BS>,
                            kRowThreads>(p, items, smem, stream, grid);
}

// The walk's launcher (bsr_row_tiled.cu, bsr_row_tiled_gated.cu): RowParams
// from the block and the call, then the instance for the dtypes and the
// block size.
template <bool Gate>
cudaError_t row_tiled_walk(const mega::Block& b, const mega::Call& c,
                           int* grid) {
  RowParams p{c.x,          b.blocks,   b.rows,     b.cols,
              b.run_ptr,    b.run_order, b.bias_idx, b.bias_tiles,
              b.scales,     c.occ0,     c.slots,    c.occ,
              c.scratch,    c.out,      c.B,        b.n_in,
              b.n_out,      b.n_layers, b.hidden_tiles, b.act,
              b.final_act,  c.epoch};
  for (int k = 0; k <= b.n_layers; ++k) p.run_seg[k] = b.seg[k];
  return with_dtypes(b.x_dtype, b.w_dtype, [&](auto xt, auto wt) {
    using XT = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    auto* go = b.bs == 128 ? &launch_row_tiled<Gate, XT, WT, 128>
                           : &launch_row_tiled<Gate, XT, WT, 64>;
    return go(p, c.stream, grid);
  });
}

}  // namespace
