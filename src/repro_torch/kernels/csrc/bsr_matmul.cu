// Hand-written Hopper (sm_90a) kernel for one scheduled block-sparse layer.
//
// bsr_matmul_kernel replaces the Pallas kernel bsr_matmul
// (src/repro/kernels/bsr_matmul.py, `bsr_matmul` / body `_kernel`): one
// layer, y = act(x @ W_bsr + b), over a Theorem-1 schedule whose steps are
// grouped into contiguous runs per output tile.
//
// What bounds it on the H100.  At the BERT-large FFNN's final layer (4096 ->
// 1024, 26 blocks of 128x128) the weights are 1.7 MB in f32: 0.53 us at
// 3.35 TB/s, and the arithmetic at serving batches (B <= 32) is far below
// the f32 FMA rate.  So the floor is latency: one launch, one round trip to
// device memory, one reduction.  The first version gave each output-tile run
// to one CTA, whose threads walked the run's blocks in 128 dependent steps
// each (8 CTAs on the final layer, on a 132-SM card).
//
// Design: every weight byte in flight at once.  The unit of work is
// (schedule step g, K-slice s of its block, chunk of kChunkRows batch rows):
// 26 steps x 4 slices = 104 CTAs on the final layer.  Each CTA walks one
// item through split_k.cuh: all its 16-byte weight loads first, x's
// [rows, K-slice] staged as f32 while they fly, the slice's product reduced
// over row groups in a fixed order into an f32 partial, then its arrival on
// the (run, chunk) counter.  The CTA that arrives last sums the run's
// partials in schedule order, then K-slice order, adds the bias, applies
// the epilogue, stores the tile and resets the counter, so the result is
// deterministic.  The megakernel (bsr_kernels.cu) walks every layer the
// same way.  The schedule metadata (step -> run, the first partial of each
// step, the K-slice height and the vector width) is built once in Python
// when the schedule is compiled.  Launches of one schedule must be ordered
// on one stream: they share the arrival counters.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the attribute call's own error).

#include <cuda_runtime.h>

#include <cstddef>

#include "split_k.cuh"

namespace {

// partial [n_parts, B, bn] f32; arrivals [n_runs, gridDim.y] int, zero
// between launches
template <typename XT, typename WT, int VE>
__global__ void __launch_bounds__(kThreads)
    bsr_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ blocks,
                      const int* __restrict__ rows,
                      const int* __restrict__ cols,
                      const int* __restrict__ run_ptr,
                      const int* __restrict__ step_run,
                      const int* __restrict__ part_off,
                      const float* __restrict__ bias,
                      const float* __restrict__ scales, float* partial,
                      int* arrivals, XT* __restrict__ out, int B, int n_in,
                      int n_out, int bm, int bn, int k_slice, int n_slices,
                      int act) {
  extern __shared__ float smem[];
  __shared__ int is_last;
  const Lanes<VE> lanes(bn);
  const int g = blockIdx.x / n_slices;
  const int s = blockIdx.x - g * n_slices;
  const int chunk = blockIdx.y;
  const int b0 = chunk * kChunkRows;
  const int nrows = min(kChunkRows, B - b0);
  const int k0 = s * k_slice;
  const int kn = min(k_slice, bm - k0);  // rows of W in this slice

  // 1. every weight load of the CTA in flight before anything waits on it;
  // the run's metadata is read meanwhile, for the reduction
  WRegs<WT, VE> w;
  load_slice<WT, VE>(w, blocks + ((size_t)g * bm + k0) * bn, kn, bn, lanes);
  const float sc = scales != nullptr ? scales[g] : 1.f;
  const int run = step_run[g];
  const int c = cols[g];
  float* xs = smem;                      // [k_slice][kXsStride]
  float* red = smem + xs_floats(k_slice);  // [kgs][kSubRows][bn]
  stage_slice<false>(xs, x + (size_t)b0 * n_in + (size_t)rows[g] * bm + k0,
                     n_in, nrows, k_slice, kn);
  const int g0 = run_ptr[run];
  const int g1 = run_ptr[run + 1];
  const int p0 = part_off[g0];
  __syncthreads();

  // 2. the slice's product into the partial
  float* part = partial + ((size_t)(part_off[g] + s) * B + b0) * bn;
  slice_product<WT, VE>(w, sc, xs, red, part, nrows, kn, bn, lanes);

  // 3. the last CTA of the (run, chunk) reduces it
  if (!arrive(arrivals + (size_t)run * gridDim.y + chunk,
              (g1 - g0) * n_slices, &is_last))
    return;
  OutTile<XT> dst{out + (size_t)b0 * n_out + (size_t)c * bn, n_out};
  reduce_run(partial + ((size_t)p0 * B + b0) * bn, g1 - g0, n_slices,
             (size_t)B * bn, nrows, bn, bias + (size_t)c * bn, act, dst);
}

template <typename XT, typename WT, int VE>
cudaError_t launch(const void* x, const void* blocks, const int* rows,
                   const int* cols, const int* run_ptr, const int* step_run,
                   const int* part_off, const float* bias,
                   const float* scales, float* partial, int* arrivals,
                   void* out, int B, int n_in, int n_out, int bm, int bn,
                   int n_steps, int k_slice, int n_slices, int act,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * item_smem_floats<VE>(k_slice, bn);
  auto kernel = bsr_matmul_kernel<XT, WT, VE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_steps * n_slices, (B + kChunkRows - 1) / kChunkRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(blocks), rows, cols,
      run_ptr, step_run, part_off, bias, scales, partial, arrivals,
      static_cast<XT*>(out), B, n_in, n_out, bm, bn, k_slice, n_slices, act);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 float32, 1 bfloat16.  w_dtype: 0 float32, 1 bfloat16,
// 2 float8_e4m3fn.  vec: weight elements per load, 16 bytes' worth or 1.
// scales may be null (unit scale).
extern "C" int bsr_matmul_launch(
    int x_dtype, int w_dtype, const void* x, const void* blocks,
    const int* rows, const int* cols, const int* run_ptr, const int* step_run,
    const int* part_off, const float* bias, const float* scales,
    float* partial, int* arrivals, void* out, int B, int n_in, int n_out,
    int bm, int bn, int n_steps, int k_slice, int n_slices, int vec, int act,
    void* stream) {
  if (!vec_ok(vec, w_dtype)) return (int)cudaErrorInvalidValue;
  return (int)with_dtypes(x_dtype, w_dtype, [&](auto xt, auto wt) {
    using XT = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    auto* go = vec != 1 ? &launch<XT, WT, kVec<WT>> : &launch<XT, WT, 1>;
    return go(x, blocks, rows, cols, run_ptr, step_run, part_off, bias,
              scales, partial, arrivals, out, B, n_in, n_out, bm, bn, n_steps,
              k_slice, n_slices, act, static_cast<cudaStream_t>(stream));
  });
}
