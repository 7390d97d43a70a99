// Hand-written Hopper (sm_90a) kernel for the grouped expert FFN.
//
// moe_ffn_kernel replaces the Pallas kernel moe_ffn
// (src/repro/kernels/moe_ffn.py, `moe_ffn` / body `_kernel`):
// out[e] = act(x[e] @ Wu[e]).astype(x.dtype) @ Wd[e] over capacity-grouped
// tokens x [E, C, d], Wu [E, d, f], Wd [E, f, d], all f32 or all bf16, with
// an f32 accumulator that spans the f-tiles and one write of the output.
//
// What bounds it on the H100.  At the expert widths of Granite-3.0-1B-A400M
// (E = 32, d = 1024, f = 512, C = 640) one call moves about 302 MB in f32
// (x, Wu, Wd and the output once each: 90 us at 3.35 TB/s) and does
// 2 * 2 * E * C * d * f = 42.9 GFLOP (640 us at the 67 TFLOP/s f32 rate
// outside the tensor cores).  So the arithmetic bounds it.  This first
// version keeps the arithmetic in plain f32 FMA (no tensor cores, no TF32),
// which is what the reference's f32 accumulation asks for; wgmma and TMA are
// later work.
//
// Design.  The Pallas grid (experts, f-tiles) walks one expert's f-tiles in
// order on one core, carrying the accumulator in VMEM.  Here one CTA of 256
// threads takes one (expert e, tile of kTileRows = 16 token rows) and walks
// all of e's f-tiles itself, so nothing has to carry between CTAs.  It stages
// its x rows in shared memory as f32 once, and keeps the f32 accumulator
// [16, d] in shared memory across the f-tiles.  For each f-tile it
//   1. computes h = act(x_tile @ Wu[e][:, f-tile]) into shared memory,
//      rounded to x's dtype as the reference rounds it (moe_ffn.py:38);
//   2. adds h @ Wd[e][f-tile, :] into the accumulator.
// h never goes to device memory: that is the kernel's whole point
// (moe_ffn.py:5-8).  Each thread owns one output column (of h, then of the
// accumulator) for 8 rows, reads the weight column with loads that are
// coalesced across the warp, and reads x or h as float4 broadcasts from
// shared memory.  Shared memory is 4 * 16 * (2 * d4 + f_tile4) bytes, where
// d4 and f_tile4 round up to a multiple of 4 (160 KB at d = 1024,
// f_tile = 512); any d and f_tile that fit are taken.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the attribute call's own error).

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kMoeThreads = 256;
constexpr int kTileRows = 16;      // token rows per CTA
constexpr int kRowsPerThread = 8;  // rows of one thread's column
constexpr int kGroups = kTileRows / kRowsPerThread;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// a[i] += sum_k s[i * stride + k] * w[k * w_stride], k < K, for the
// kRowsPerThread rows of s; s rows are 16-byte aligned
template <typename T>
__device__ __forceinline__ void dot_rows(float (&a)[kRowsPerThread],
                                         const float* s, int stride,
                                         const T* __restrict__ w,
                                         size_t w_stride, int K) {
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    const float w0 = to_f32(w[(size_t)k * w_stride]);
    const float w1 = to_f32(w[(size_t)(k + 1) * w_stride]);
    const float w2 = to_f32(w[(size_t)(k + 2) * w_stride]);
    const float w3 = to_f32(w[(size_t)(k + 3) * w_stride]);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(s + i * stride + k);
      a[i] = fmaf(v.x, w0, a[i]);
      a[i] = fmaf(v.y, w1, a[i]);
      a[i] = fmaf(v.z, w2, a[i]);
      a[i] = fmaf(v.w, w3, a[i]);
    }
  }
  for (; k < K; ++k) {
    const float wk = to_f32(w[(size_t)k * w_stride]);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      a[i] = fmaf(s[i * stride + k], wk, a[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMoeThreads)
    moe_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w_up,
                   const T* __restrict__ w_down, T* __restrict__ out, int C,
                   int d, int f, int f_tile, int act) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = round4(d);
  const int fp = round4(f_tile);
  float* xs = smem;                     // [kTileRows][dp]  x rows, f32
  float* acc = xs + kTileRows * dp;     // [kTileRows][dp]  f32 accumulator
  float* hs = acc + kTileRows * dp;     // [kTileRows][fp]  h of one f-tile
  const int e = blockIdx.y;
  const int c0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, C - c0);
  const T* xe = x + ((size_t)e * C + c0) * d;
  const T* wu = w_up + (size_t)e * d * f;
  const T* wd = w_down + (size_t)e * f * d;

  for (int idx = threadIdx.x; idx < kTileRows * dp; idx += blockDim.x) {
    const int i = idx / dp;
    const int k = idx - i * dp;
    xs[idx] = i < rows && k < d ? to_f32(xe[(size_t)i * d + k]) : 0.f;
    acc[idx] = 0.f;
  }
  __syncthreads();

  for (int f0 = 0; f0 < f; f0 += f_tile) {
    // 1. h = act(x_tile @ Wu[e][:, f0:f0+f_tile]), rounded to T
    for (int u = threadIdx.x; u < f_tile * kGroups; u += blockDim.x) {
      const int j = u % f_tile;
      const int i0 = (u / f_tile) * kRowsPerThread;
      float a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = 0.f;
      dot_rows(a, xs + i0 * dp, dp, wu + f0 + j, (size_t)f, d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hs[(i0 + i) * fp + j] =
            round_to(activate(a[i], act), static_cast<const T*>(nullptr));
    }
    __syncthreads();
    // 2. acc += h @ Wd[e][f0:f0+f_tile, :]; each (column, row group) has
    // one owner in every f-tile, so the accumulator needs no atomics
    for (int u = threadIdx.x; u < d * kGroups; u += blockDim.x) {
      const int n = u % d;
      const int i0 = (u / d) * kRowsPerThread;
      float a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = acc[(i0 + i) * dp + n];
      dot_rows(a, hs + i0 * fp, fp, wd + (size_t)f0 * d + n, (size_t)d,
               f_tile);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[(i0 + i) * dp + n] = a[i];
    }
    __syncthreads();  // hs is rewritten by the next f-tile
  }

  T* oe = out + ((size_t)e * C + c0) * d;
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
    const int i = idx / d;
    const int n = idx - i * d;
    store(oe + (size_t)i * d + n, acc[i * dp + n]);
  }
}

template <typename T>
cudaError_t launch_moe(const void* x, const void* w_up, const void* w_down,
                       void* out, int E, int C, int d, int f, int f_tile,
                       int act, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kTileRows * (2 * (size_t)round4(d) + round4(f_tile));
  auto kernel = moe_ffn_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + kTileRows - 1) / kTileRows, E);
  kernel<<<grid, kMoeThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up),
      static_cast<const T*>(w_down), static_cast<T*>(out), C, d, f, f_tile,
      act);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w_up, w_down and out all of it).
extern "C" int moe_ffn_launch(int dtype, const void* x, const void* w_up,
                              const void* w_down, void* out, int E, int C,
                              int d, int f, int f_tile, int act,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_moe<float>(x, w_up, w_down, out, E, C, d, f, f_tile,
                                    act, s);
    case 1:
      return (int)launch_moe<__nv_bfloat16>(x, w_up, w_down, out, E, C, d, f,
                                            f_tile, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
