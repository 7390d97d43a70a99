// Hand-written Hopper (sm_90a) kernels for scheduled block-sparse inference.
//
// The single-layer kernel, bsr_matmul, lives in bsr_matmul.cu.
//
// bsr_megakernel_kernel replaces the Pallas kernel bsr_megakernel (same
// file, `bsr_megakernel` / body `_megakernel`, ungated): the whole net in one
// launch over the flat cross-layer schedule, one hidden epilogue and one
// final epilogue.  Its gated instance (Gate = true) replaces the same Pallas
// kernel with gate=True (gating at bsr_matmul.py:208-217, occupancy counts
// at :258-262): see "Gating" below.
//
// What bounds them on the H100.  They stream every scheduled weight block
// from device memory once; at the paper's BERT-large FFNN (1024 -> 4096 ->
// 1024, density 0.1, 128x128 tiles) that is 4,259,840 B in f32 (65 blocks,
// patch blocks included), about 1.3 us at 3.35 TB/s.  The arithmetic,
// 2 * B * 128 * 128 per block, is far below the f32 FMA rate at serving
// batches (B <= 32).  So at these sizes the floor is the launch latency
// (several microseconds), not bytes or operations.  The designs answer that
// first with fewer launches (one per forward for the megakernel) and keep the
// per-launch work simple; wgmma, TMA and tuning are later work.
//
// Design of both instances.  The Pallas grid is one sequential walk on
// one TPU core; here the output-tile runs of a layer are independent, so one
// CTA of 128 threads takes one (run, chunk of kRows batch rows) work item.
// Thread t owns output column t of the tile (columns loop in steps of 128 for
// wider tiles) and keeps kRows f32 accumulators in registers.  The CTA walks
// its run's blocks in schedule order, stages the [kRows, bm] input tile in
// shared memory as f32 and re-stages it only when rows[g] changes (the
// schedule's input reuse), dequantizes each weight element right before its
// FMA (float(q) * scale, q in f32/bf16/fp8 via the cuda_bf16.h/cuda_fp8.h
// intrinsics), and applies bias and epilogue once, at the end of the run.
// Accumulation is plain f32 FMA: no tensor cores, no TF32.  Any batch size
// works: the last row chunk is masked.
//
// Megakernel specifics.  One cooperative launch walks the layers in order;
// within a layer CTAs take that layer's work items in a grid-stride loop
// (32 runs in layer 0 of the BERT net, 8 in layer 1, times the row chunks),
// and cg::this_grid().sync() separates layers.  The grid is capped at the
// co-resident CTA count the occupancy query reports, as a cooperative launch
// requires.  Hidden activations stay f32 in a ping-pong buffer
// [2, hidden_tiles, B, bs] that the wrapper allocates: at the BERT width one
// buffer is 32 * B * 128 * 4 B = 16 KiB * B (512 KiB at B = 32), far over
// the 227 KB of shared memory a CTA may use, so the hidden state lives in
// global memory and stays resident in the 50 MB L2.  It is written and read
// with __stcg/__ldcg (L2, bypassing the per-SM L1), since other CTAs of the
// same launch produce it.
//
// Gating.  The gated megakernel takes occ0 [grid_in_0] (live-row counts of
// x's input tiles, computed by the wrapper on the card) and fills occ
// [max(1, n_layers-1), hidden_tiles], which the wrapper zeroes with
// torch.zeros (one memset launch; zeroing in the kernel would need its own
// grid.sync()).  A step whose input tile has occupancy 0 skips the input
// staging, the weight-block read and the product: the skipped contribution
// is fmaf(+-0, w, acc) == acc for finite w, so the gated output is
// bit-identical to the ungated one, and the weight bytes of dead steps are
// never read (the TPU pipeline still streamed them; here the read is what
// gating saves).  The epilogue always runs, so an all-dead run still writes
// act(bias).  Each non-final epilogue counts, per batch row b0+i < B of its
// chunk, whether any column of the tile it wrote is nonzero
// (__syncthreads_or per row, so the answer spans all columns of the CTA),
// and thread 0 atomicAdds the live-row count into occ[k][c]: a tile's count
// sums over the row chunks that different CTAs own.  Rows past B never
// count (the reference's valid_b).  Layer k+1 reads occ[k] only after the
// layer's grid.sync(), through L2 (__ldcg), since other CTAs wrote it.
//
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the launch API's own error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // one thread per column of a 128-wide tile
constexpr int kRows = 8;       // batch rows per work item

// x [B, n_in]: element k of input tile r for batch row b
template <typename XT>
struct XSource {
  const XT* x;
  int n_in;
  int bm;
  __device__ float operator()(int b, int r, int k) const {
    return to_f32(x[(size_t)b * n_in + (size_t)r * bm + k]);
  }
};

// hidden [tiles, B, bs], written by other CTAs of this launch: read via L2
struct HiddenSource {
  const float* h;
  int B;
  int bs;
  __device__ float operator()(int b, int r, int k) const {
    return __ldcg(h + ((size_t)r * B + b) * bs + k);
  }
};

// out [B, n_out]: column n of output tile c for batch row b
template <typename OT>
struct OutSink {
  OT* out;
  int n_out;
  int bn;
  __device__ void operator()(int b, int c, int n, float v) const {
    store(out + (size_t)b * n_out + (size_t)c * bn + n, v);
  }
};

struct HiddenSink {
  float* h;
  int B;
  int bs;
  __device__ void operator()(int b, int c, int n, float v) const {
    __stcg(h + ((size_t)c * B + b) * bs + n, v);
  }
};

// One output-tile run (schedule steps g0..g1-1, all with output tile c) for
// batch rows b0 .. b0+kRows-1 that are < B.  xs: kRows * bm floats of shared
// memory.  Every thread of the CTA calls this with the same arguments.
// Gate: skip the steps whose input tile r has occ_in[r] == 0 and, when
// occ_out is not null, add the chunk's live-row count of tile c to
// occ_out[c].
template <bool Gate, typename WT, typename Src, typename Dst>
__device__ void run_tile(const Src& src, const Dst& dst,
                         const WT* __restrict__ blocks,
                         const float* __restrict__ scales,
                         const int* __restrict__ rows, int g0, int g1, int c,
                         int bm, int bn, int B, int b0,
                         const float* __restrict__ bias_tile, int act,
                         float* xs, const int* occ_in, int* occ_out) {
  const size_t block_elems = (size_t)bm * bn;
  unsigned live = 0;  // Gate: bit i set when row b0+i has a nonzero in tile c
  for (int n0 = 0; n0 < bn; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    const bool active = n < bn;
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    int cur = -1;
    for (int g = g0; g < g1; ++g) {
      const int r = rows[g];
      if constexpr (Gate) {
        // a dead input tile: no staging, no weight read, no product (the
        // same value for every thread, so the branch is uniform)
        if (__ldcg(occ_in + r) == 0) continue;
      }
      if (r != cur) {  // stage the input tile only when rows[g] changes
        __syncthreads();
        for (int e = threadIdx.x; e < kRows * bm; e += blockDim.x) {
          const int i = e / bm;
          const int k = e - i * bm;
          xs[e] = b0 + i < B ? src(b0 + i, r, k) : 0.f;
        }
        __syncthreads();
        cur = r;
      }
      if (active) {
        const WT* w = blocks + (size_t)g * block_elems + n;
        const float s = scales != nullptr ? scales[g] : 1.f;
#pragma unroll 4
        for (int k = 0; k < bm; ++k) {
          const float wk = to_f32(w[(size_t)k * bn]) * s;
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i] = fmaf(xs[i * bm + k], wk, acc[i]);
        }
      }
    }
    if (active) {
      const float bv = bias_tile[n];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (b0 + i < B) dst(b0 + i, c, n, activate(acc[i] + bv, act));
      }
    }
    if constexpr (Gate) {
      if (occ_out != nullptr) {  // the same value the epilogue stored
        const float bv = active ? bias_tile[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const bool nz =
              active && b0 + i < B && activate(acc[i] + bv, act) != 0.f;
          if (__syncthreads_or(nz)) live |= 1u << i;
        }
      }
    }
  }
  if constexpr (Gate) {
    if (occ_out != nullptr && threadIdx.x == 0 && live != 0)
      atomicAdd(occ_out + c, __popc(live));
  }
}

// occ0 [grid_in_0] and occ [max(1, n_layers-1), hidden_tiles]: read and
// written by the Gate instance only (null otherwise)
template <bool Gate, typename XT, typename WT>
__global__ void __launch_bounds__(kThreads) bsr_megakernel_kernel(
    const XT* __restrict__ x, const WT* __restrict__ blocks,
    const int* __restrict__ rows, const int* __restrict__ cols,
    const int* __restrict__ run_ptr, const int* __restrict__ layer_runs,
    const int* __restrict__ bias_idx, const float* __restrict__ bias_tiles,
    const float* __restrict__ scales, const int* occ0, int* occ,
    float* hidden, XT* __restrict__ out, int B, int n_in, int n_out, int bs,
    int n_layers, int hidden_tiles, int act, int final_act) {
  extern __shared__ float xs[];
  cg::grid_group grid = cg::this_grid();
  const int chunks = (B + kRows - 1) / kRows;
  const size_t hbuf = (size_t)hidden_tiles * B * bs;
  for (int k = 0; k < n_layers; ++k) {
    const int run0 = layer_runs[k];
    const int items = (layer_runs[k + 1] - run0) * chunks;
    const bool is_final = k == n_layers - 1;
    const int a = is_final ? final_act : act;
    float* h_out = hidden + (size_t)(k % 2) * hbuf;
    const HiddenSource h_in{hidden + (size_t)((k + 1) % 2) * hbuf, B, bs};
    const int* occ_in = nullptr;
    int* occ_out = nullptr;
    if (Gate) {
      occ_in = k == 0 ? occ0 : occ + (size_t)(k - 1) * hidden_tiles;
      if (!is_final) occ_out = occ + (size_t)k * hidden_tiles;
    }
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int run = run0 + it / chunks;
      const int b0 = (it % chunks) * kRows;
      const int g0 = run_ptr[run];
      const int g1 = run_ptr[run + 1];
      const int c = cols[g0];
      const float* bias = bias_tiles + (size_t)bias_idx[g0] * bs;
      if (k == 0) {
        const XSource<XT> src{x, n_in, bs};
        if (is_final) {
          run_tile<Gate>(src, OutSink<XT>{out, n_out, bs}, blocks, scales,
                         rows, g0, g1, c, bs, bs, B, b0, bias, a, xs, occ_in,
                         occ_out);
        } else {
          run_tile<Gate>(src, HiddenSink{h_out, B, bs}, blocks, scales, rows,
                         g0, g1, c, bs, bs, B, b0, bias, a, xs, occ_in,
                         occ_out);
        }
      } else if (is_final) {
        run_tile<Gate>(h_in, OutSink<XT>{out, n_out, bs}, blocks, scales,
                       rows, g0, g1, c, bs, bs, B, b0, bias, a, xs, occ_in,
                       occ_out);
      } else {
        run_tile<Gate>(h_in, HiddenSink{h_out, B, bs}, blocks, scales, rows,
                       g0, g1, c, bs, bs, B, b0, bias, a, xs, occ_in,
                       occ_out);
      }
    }
    // layer k's hidden tiles (and, gated, their occupancy) are complete
    if (!is_final) grid.sync();
  }
}

template <bool Gate, typename XT, typename WT>
cudaError_t launch_megakernel(const void* x_, const void* blocks_,
                              const int* rows, const int* cols,
                              const int* run_ptr, const int* layer_runs,
                              const int* bias_idx, const float* bias_tiles,
                              const float* scales, const int* occ0, int* occ,
                              float* hidden, void* out_, int B, int n_in,
                              int n_out, int bs, int n_layers,
                              int hidden_tiles, int max_layer_runs, int act,
                              int final_act, cudaStream_t stream) {
  auto kernel = bsr_megakernel_kernel<Gate, XT, WT>;
  const size_t smem = (size_t)kRows * bs * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int chunks = (B + kRows - 1) / kRows;
  int grid = max_layer_runs * chunks;
  if (grid > per_sm * sms) grid = per_sm * sms;  // all CTAs co-resident
  if (grid < 1) grid = 1;

  const XT* x = static_cast<const XT*>(x_);
  const WT* blocks = static_cast<const WT*>(blocks_);
  XT* out = static_cast<XT*>(out_);
  void* args[] = {&x,          &blocks,   &rows,       &cols,   &run_ptr,
                  &layer_runs, &bias_idx, &bias_tiles, &scales, &occ0,
                  &occ,        &hidden,   &out,        &B,      &n_in,
                  &n_out,      &bs,       &n_layers,   &hidden_tiles,
                  &act,        &final_act};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool Gate>
int megakernel_dispatch(int x_dtype, int w_dtype, const void* x,
                        const void* blocks, const int* rows, const int* cols,
                        const int* run_ptr, const int* layer_runs,
                        const int* bias_idx, const float* bias_tiles,
                        const float* scales, const int* occ0, int* occ,
                        float* hidden, void* out, int B, int n_in, int n_out,
                        int bs, int n_layers, int hidden_tiles,
                        int max_layer_runs, int act, int final_act,
                        cudaStream_t s) {
#define BSR_MEGA(XT, WT)                                                     \
  return (int)launch_megakernel<Gate, XT, WT>(                              \
      x, blocks, rows, cols, run_ptr, layer_runs, bias_idx, bias_tiles,     \
      scales, occ0, occ, hidden, out, B, n_in, n_out, bs, n_layers,         \
      hidden_tiles, max_layer_runs, act, final_act, s)
  switch (x_dtype * 3 + w_dtype) {
    case 0: BSR_MEGA(float, float);
    case 1: BSR_MEGA(float, __nv_bfloat16);
    case 2: BSR_MEGA(float, __nv_fp8_e4m3);
    case 3: BSR_MEGA(__nv_bfloat16, float);
    case 4: BSR_MEGA(__nv_bfloat16, __nv_bfloat16);
    case 5: BSR_MEGA(__nv_bfloat16, __nv_fp8_e4m3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BSR_MEGA
}

}  // namespace

// Gated when occ is not null: then occ0 [grid_in_0] is read and occ
// [max(1, n_layers-1), hidden_tiles], zeroed by the caller, is filled.
extern "C" int bsr_megakernel_launch(
    int x_dtype, int w_dtype, const void* x, const void* blocks,
    const int* rows, const int* cols, const int* run_ptr,
    const int* layer_runs, const int* bias_idx, const float* bias_tiles,
    const float* scales, const int* occ0, int* occ, float* hidden, void* out,
    int B, int n_in, int n_out, int bs, int n_layers, int hidden_tiles,
    int max_layer_runs, int act, int final_act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (occ != nullptr) {
    if (occ0 == nullptr) return (int)cudaErrorInvalidValue;
    return megakernel_dispatch<true>(
        x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, layer_runs,
        bias_idx, bias_tiles, scales, occ0, occ, hidden, out, B, n_in, n_out,
        bs, n_layers, hidden_tiles, max_layer_runs, act, final_act, s);
  }
  return megakernel_dispatch<false>(
      x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, layer_runs, bias_idx,
      bias_tiles, scales, nullptr, nullptr, hidden, out, B, n_in, n_out, bs,
      n_layers, hidden_tiles, max_layer_runs, act, final_act, s);
}
