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
// 26 steps x 4 slices = 104 CTAs on the final layer.  A CTA
//   1. issues all its 16-byte weight loads first (each thread owns one
//      column group of VE elements and up to kMaxVec rows of the slice;
//      neighbouring threads read neighbouring 16 bytes), then stages x's
//      [rows, K-slice] in shared memory as f32 while they fly;
//   2. dequantizes (float(q) * scale) and takes the slice's product for 8
//      rows at a time (4 for fp8), reduces the kg row-groups in shared memory in a fixed
//      order, and writes an f32 partial [rows, bn] to `partial` (through L2);
//   3. counts its arrival on the (run, chunk) counter.  The CTA that arrives
//      last sums the run's partials in schedule order, then K-slice order,
//      adds the bias, applies the epilogue, stores the tile and resets the
//      counter to 0 for the next launch.  The sum's order never depends on
//      which CTA finished when, so the result is deterministic.
// The schedule metadata (step -> run, the first partial of each step, the
// K-slice height and the vector width) is built once in Python when the
// schedule is compiled.  Accumulation is plain f32 FMA: no tensor cores, no
// TF32.  Launches of one schedule must be ordered on one stream: they share
// the arrival counters.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the attribute call's own error).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunkRows = 32;  // batch rows per CTA (grid.y)
// rows per pass over the weight registers: 4 for fp8's 16-wide vectors,
// so that the accumulators ([rows][VE]) stay within the register file
template <int VE>
__host__ __device__ constexpr int sub_rows() {
  return VE == 16 ? 4 : 8;
}
constexpr int kMaxVec = 8;      // weight vectors a thread holds

// VE weight elements loaded as one unit: 16 bytes when VE > 1, else one.
template <typename WT, int VE>
struct WLoad {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const WT* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
};
template <typename WT>
struct WLoad<WT, 1> {
  using Raw = WT;
  static __device__ __forceinline__ Raw load(const WT* p) { return p[0]; }
};

__device__ __forceinline__ float fp8_at(unsigned word, int j) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>((word >> (8 * j)) & 0xffu), __NV_E4M3);
  return __half2float(__half(h));
}

// the VE weights of one load, widened to f32 and scaled
template <int VE>
__device__ __forceinline__ void unpack(const uint4& r, float (&w)[VE],
                                       float s, const float*) {
  static_assert(VE == 4, "f32 vectors hold 4 elements");
  w[0] = __uint_as_float(r.x) * s;
  w[1] = __uint_as_float(r.y) * s;
  w[2] = __uint_as_float(r.z) * s;
  w[3] = __uint_as_float(r.w) * s;
}
template <int VE>
__device__ __forceinline__ void unpack(const uint4& r, float (&w)[VE],
                                       float s, const __nv_bfloat16*) {
  static_assert(VE == 8, "bf16 vectors hold 8 elements");
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[2 * q] = __uint_as_float(u[q] << 16) * s;
    w[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u) * s;
  }
}
template <int VE>
__device__ __forceinline__ void unpack(const uint4& r, float (&w)[VE],
                                       float s, const __nv_fp8_e4m3*) {
  static_assert(VE == 16, "fp8 vectors hold 16 elements");
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * q + j] = fp8_at(u[q], j) * s;
  }
}
template <int VE, typename WT>
__device__ __forceinline__ void unpack(const WT& r, float (&w)[VE], float s,
                                       const WT*) {
  w[0] = to_f32(r) * s;
}

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
  using Load = WLoad<WT, VE>;
  constexpr int kSubRows = sub_rows<VE>();
  extern __shared__ float smem[];
  __shared__ int is_last;
  const int g = blockIdx.x / n_slices;
  const int s = blockIdx.x - g * n_slices;
  const int chunk = blockIdx.y;
  const int b0 = chunk * kChunkRows;
  const int nrows = min(kChunkRows, B - b0);
  const int k0 = s * k_slice;
  const int kn = min(k_slice, bm - k0);  // rows of W in this slice
  const int nc = bn / VE;                 // column groups
  const int kgs = kThreads / nc;          // row groups
  const int t = threadIdx.x;
  const int kg = t / nc;
  const int cg = t - kg * nc;
  const bool active = kg < kgs;

  // 1. every weight load of the CTA in flight before anything waits on it
  typename Load::Raw w[kMaxVec];
  const WT* wb = blocks + ((size_t)g * bm + k0) * bn + (size_t)cg * VE;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = kg + i * kgs;
    if (active && k < kn) w[i] = Load::load(wb + (size_t)k * bn);
  }
  const float sc = scales != nullptr ? scales[g] : 1.f;
  float* xs = smem;                          // [kChunkRows][k_slice]
  float* red = smem + kChunkRows * k_slice;  // [kgs][kSubRows][bn]
  const XT* xr = x + (size_t)b0 * n_in + (size_t)rows[g] * bm + k0;
  for (int e = t; e < nrows * k_slice; e += kThreads) {
    const int i = e / k_slice;
    const int k = e - i * k_slice;
    xs[e] = k < kn ? to_f32(xr[(size_t)i * n_in + k]) : 0.f;
  }
  __syncthreads();

  // 2. the slice's product, kSubRows rows at a time, into the partial
  float* part = partial + ((size_t)(part_off[g] + s) * B + b0) * bn;
  for (int i0 = 0; i0 < nrows; i0 += kSubRows) {
    if (active) {
      float acc[kSubRows][VE];
#pragma unroll
      for (int r = 0; r < kSubRows; ++r) {
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[r][j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        const int k = kg + i * kgs;
        if (k < kn) {
          float wf[VE];
          unpack<VE>(w[i], wf, sc, static_cast<const WT*>(nullptr));
#pragma unroll
          for (int r = 0; r < kSubRows; ++r) {
            // rows past nrows read stale staging; their sums are never stored
            const float xv = xs[(i0 + r) * k_slice + k];
#pragma unroll
            for (int j = 0; j < VE; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kSubRows; ++r) {
#pragma unroll
        for (int j = 0; j < VE; ++j)
          red[(kg * kSubRows + r) * bn + cg * VE + j] = acc[r][j];
      }
    }
    __syncthreads();
    for (int o = t; o < kSubRows * bn; o += kThreads) {
      const int r = o / bn;
      const int n = o - r * bn;
      if (i0 + r < nrows) {
        float v = 0.f;
        for (int q = 0; q < kgs; ++q) v += red[(q * kSubRows + r) * bn + n];
        __stcg(part + (size_t)(i0 + r) * bn + n, v);
      }
    }
    __syncthreads();  // red is rewritten by the next pass
  }

  // 3. the last CTA of the (run, chunk) reduces it
  __threadfence();  // this thread's partial is visible card-wide ...
  __syncthreads();  // ... for every thread, before the arrival counts
  const int run = step_run[g];
  const int g0 = run_ptr[run];
  const int g1 = run_ptr[run + 1];
  if (t == 0) {
    int* cnt = arrivals + (size_t)run * gridDim.y + chunk;
    const int expected = (g1 - g0) * n_slices;
    const int prev = atomicAdd(cnt, 1);
    is_last = prev == expected - 1;
    if (is_last) *cnt = 0;  // every arrival of this launch is counted
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // a run's partials are contiguous, in schedule order then K-slice order
  const int c = cols[g];
  const int p0 = part_off[g0];
  const int np = (g1 - g0) * n_slices;
  const size_t part_stride = (size_t)B * bn;
  for (int o = t; o < nrows * bn; o += kThreads) {
    const int i = o / bn;
    const int n = o - i * bn;
    const float* p = partial + ((size_t)p0 * B + b0 + i) * bn + n;
    const float bv = bias[(size_t)c * bn + n];
    float v = 0.f;
#pragma unroll 8
    for (int q = 0; q < np; ++q) v += __ldcg(p + q * part_stride);
    store(out + (size_t)(b0 + i) * n_out + (size_t)c * bn + n,
          activate(v + bv, act));
  }
}

template <typename XT, typename WT, int VE>
cudaError_t launch(const void* x, const void* blocks, const int* rows,
                   const int* cols, const int* run_ptr, const int* step_run,
                   const int* part_off, const float* bias,
                   const float* scales, float* partial, int* arrivals,
                   void* out, int B, int n_in, int n_out, int bm, int bn,
                   int n_steps, int k_slice, int n_slices, int act,
                   cudaStream_t stream) {
  const int kgs = kThreads / (bn / VE);
  const size_t smem = sizeof(float) * ((size_t)kChunkRows * k_slice +
                                       (size_t)kgs * sub_rows<VE>() * bn);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec * (w_dtype == 0 ? 4 : w_dtype == 1 ? 2 : 1) != 16)
    return (int)cudaErrorInvalidValue;
#define BSR_MATMUL(XT, WT, VE)                                             \
  return (int)launch<XT, WT, VE>(x, blocks, rows, cols, run_ptr, step_run, \
                                 part_off, bias, scales, partial, arrivals, \
                                 out, B, n_in, n_out, bm, bn, n_steps,     \
                                 k_slice, n_slices, act, s)
  const bool v = vec != 1;
  switch (x_dtype * 3 + w_dtype) {
    case 0: if (v) BSR_MATMUL(float, float, 4); BSR_MATMUL(float, float, 1);
    case 1:
      if (v) BSR_MATMUL(float, __nv_bfloat16, 8);
      BSR_MATMUL(float, __nv_bfloat16, 1);
    case 2:
      if (v) BSR_MATMUL(float, __nv_fp8_e4m3, 16);
      BSR_MATMUL(float, __nv_fp8_e4m3, 1);
    case 3:
      if (v) BSR_MATMUL(__nv_bfloat16, float, 4);
      BSR_MATMUL(__nv_bfloat16, float, 1);
    case 4:
      if (v) BSR_MATMUL(__nv_bfloat16, __nv_bfloat16, 8);
      BSR_MATMUL(__nv_bfloat16, __nv_bfloat16, 1);
    case 5:
      if (v) BSR_MATMUL(__nv_bfloat16, __nv_fp8_e4m3, 16);
      BSR_MATMUL(__nv_bfloat16, __nv_fp8_e4m3, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BSR_MATMUL
}
