// The split-K block walk that bsr_matmul.cu and bsr_kernels.cu share.
//
// The unit of work is (schedule step g, K-slice s of its [bm, bn] weight
// block, chunk of kChunkRows batch rows).  A work item of 128 threads
//   1. issues all its 16-byte weight loads before anything waits on them
//      (load_slice: each thread owns one column group of VE elements and up
//      to kMaxVec rows of the slice; neighbouring threads read neighbouring
//      16 bytes);
//   2. stages its input rows [rows, K-slice] in shared memory as f32
//      (stage_slice);
//   3. dequantizes (float(q) * scale), takes the slice's product a few
//      rows at a time, reduces the kgs row groups in shared memory in a
//      fixed order and writes an f32 partial [rows, bn] through L2
//      (slice_product);
//   4. counts its arrival on the (output-tile run, chunk) counter (arrive).
//      The item that arrives last resets the counter and sums the run's
//      partials in schedule order, then K-slice order (reduce_run), so the
//      sum's order never depends on which item finished when.
// Both kernels run this code, so with f32 inputs one layer of the
// megakernel gives bit for bit what one bsr_matmul launch gives.
// Accumulation is plain f32 FMA: no tensor cores, no TF32.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

namespace {

constexpr int kThreads = 128;
// rows per pass over the weight registers: 4 for fp8's 16-wide vectors,
// so that the accumulators ([rows][VE]) stay within the register file
template <int VE>
__host__ __device__ constexpr int sub_rows() {
  return VE == 16 ? 4 : 8;
}
constexpr int kMaxVec = 8;  // weight vectors a thread holds

// The staged input is stored K-row by K-row, [k_slice][kXsStride]: the
// batch rows of one K-row lie next to each other, so a thread reads the
// rows of a pass with one or two vector loads; the 4 floats of padding
// spread neighbouring K-rows over the banks.
constexpr int kXsStride = kChunkRows + 4;

__host__ __device__ constexpr size_t xs_floats(int k_slice) {
  return (size_t)k_slice * kXsStride;
}

// shared memory of one work item, in floats: the staged input and the
// row-group reduction [kgs][kSubRows][bn]
template <int VE>
__host__ __device__ constexpr size_t item_smem_floats(int k_slice, int bn) {
  return xs_floats(k_slice) +
         (size_t)(kThreads / (bn / VE)) * sub_rows<VE>() * bn;
}

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

// Which part of a work item a thread owns: column group cg (VE columns)
// and row group kg (slice rows kg, kg + kgs, ...) of the weights.
template <int VE>
struct Lanes {
  int kgs, kg, cg;
  bool active;
  __device__ explicit Lanes(int bn) {
    const int nc = bn / VE;  // column groups
    kgs = kThreads / nc;     // row groups
    kg = threadIdx.x / nc;
    cg = threadIdx.x - kg * nc;
    active = kg < kgs;
  }
};

template <typename WT, int VE>
using WRegs = typename WLoad<WT, VE>::Raw[kMaxVec];

// 1. rows 0 .. kn-1 of a weight slice (wk0: its first row, rows bn apart)
template <typename WT, int VE>
__device__ __forceinline__ void load_slice(WRegs<WT, VE>& w, const WT* wk0,
                                           int kn, int bn,
                                           const Lanes<VE>& l) {
  const WT* wb = wk0 + (size_t)l.cg * VE;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = l.kg + i * l.kgs;
    if (l.active && k < kn) w[i] = WLoad<WT, VE>::load(wb + (size_t)k * bn);
  }
}

// 2. src's rows 0 .. nrows-1, columns 0 .. kn-1 (rows `stride` apart) into
// xs (K-row major, see kXsStride) as f32, zero past kn.  ViaL2: src is f32
// that other CTAs of the same launch wrote, so it is read through L2
// (__ldcg).
template <bool ViaL2, typename T>
__device__ __forceinline__ void stage_slice(float* xs, const T* src,
                                            size_t stride, int nrows,
                                            int k_slice, int kn) {
  for (int e = threadIdx.x; e < nrows * k_slice; e += kThreads) {
    const int i = e / k_slice;
    const int k = e - i * k_slice;
    float v = 0.f;
    if (k < kn) {
      const T* p = src + (size_t)i * stride + k;
      if constexpr (ViaL2) {
        v = __ldcg(p);
      } else {
        v = to_f32(*p);
      }
    }
    xs[k * kXsStride + i] = v;
  }
}

// rows i0 .. i0+R-1 of one staged K-row, in one or two vector loads
template <int R>
__device__ __forceinline__ void load_rows(float (&v)[R], const float* p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int q = 0; q < R; q += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + q);
      v[q] = u.x;
      v[q + 1] = u.y;
      v[q + 2] = u.z;
      v[q + 3] = u.w;
    }
  } else if constexpr (R == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

// the products of R rows from i0 on with the thread's weights, written to
// red [kgs][R][bn]; each accumulator takes the slice's K-rows in order
template <int R, typename WT, int VE>
__device__ __forceinline__ void product_pass(const WRegs<WT, VE>& w,
                                             float sc, const float* xs,
                                             float* red, int i0, int kn,
                                             int bn, const Lanes<VE>& l) {
  float acc[R][VE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < VE; ++j) acc[r][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = l.kg + i * l.kgs;
    if (k < kn) {
      // rows past nrows read stale staging; their sums are never stored
      float xv[R];
      load_rows<R>(xv, xs + k * kXsStride + i0);
      float wf[VE];
      unpack<VE>(w[i], wf, sc, static_cast<const WT*>(nullptr));
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < VE; ++j) acc[r][j] = fmaf(xv[r], wf[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < VE; ++j)
      red[(l.kg * R + r) * bn + l.cg * VE + j] = acc[r][j];
  }
}

// 3. the slice's product into part [nrows][bn] (f32, through L2), in
// passes over the rows: kSubRows at a time while that many are left, then
// 4 (for 3 or more), 2 or 1, so a small batch computes hardly more rows
// than it has.  red: [kgs][kSubRows][bn] floats.  xs must be staged and
// visible to every thread; ends with a barrier.
template <typename WT, int VE>
__device__ __forceinline__ void slice_product(const WRegs<WT, VE>& w,
                                              float sc, const float* xs,
                                              float* red, float* part,
                                              int nrows, int kn, int bn,
                                              const Lanes<VE>& l) {
  constexpr int kSubRows = sub_rows<VE>();
  for (int i0 = 0; i0 < nrows;) {
    const int left = nrows - i0;
    const int R = left >= kSubRows ? kSubRows : left > 2 ? 4 : left;
    if (l.active) {
      if (R == 1) {
        product_pass<1, WT, VE>(w, sc, xs, red, i0, kn, bn, l);
      } else if (R == 2) {
        product_pass<2, WT, VE>(w, sc, xs, red, i0, kn, bn, l);
      } else if (R == 4) {
        product_pass<4, WT, VE>(w, sc, xs, red, i0, kn, bn, l);
      } else if constexpr (kSubRows == 8) {
        product_pass<8, WT, VE>(w, sc, xs, red, i0, kn, bn, l);
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < R * bn; o += kThreads) {
      const int r = o / bn;
      const int n = o - r * bn;
      if (i0 + r < nrows) {
        float v = 0.f;
#pragma unroll 8
        for (int q = 0; q < l.kgs; ++q) v += red[(q * R + r) * bn + n];
        __stcg(part + (size_t)(i0 + r) * bn + n, v);
      }
    }
    __syncthreads();  // red is rewritten by the next pass
    i0 += R;
  }
}

// 4. count this item's arrival on *cnt; true, in every thread, for the
// item that arrives last (`expected` arrivals in all), which resets the
// counter to 0 for the next launch and then sees every item's partial.
// flag: one int of shared memory.
__device__ __forceinline__ bool arrive(int* cnt, int expected, int* flag) {
  __threadfence();  // this thread's partial is visible card-wide ...
  __syncthreads();  // ... for every thread, before the arrival counts
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(cnt, 1);
    *flag = prev == expected - 1;
    if (*flag) *cnt = 0;  // every arrival of this launch is counted
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// reduce_run's sink for a tile of T rows `stride` elements apart
template <typename T>
struct OutTile {
  T* p;
  int stride;
  __device__ __forceinline__ void operator()(int i, int n, float y) const {
    store(p + (size_t)i * stride + n, y);
  }
};

// 5. the run's sum for rows 0 .. nrows-1 of the item's chunk: partials
// part0[q] ([.., B, bn] apart; the run's are contiguous, in schedule order
// then K-slice order) for its `steps` steps of n_slices slices each, plus
// the bias, through the epilogue; out(i, n, y) stores each value.  Each
// value is summed in the order q = 0, 1, ..., whatever the load width.
// Where rows allow 16-byte loads (bn % 4 == 0) a thread sums four columns
// at once, so that one round of loads serves four outputs.
template <typename Out>
__device__ __forceinline__ void reduce_run(const float* part0, int steps,
                                           int n_slices, size_t part_stride,
                                           int nrows, int bn,
                                           const float* bias, int act,
                                           const Out& out) {
  const int np = steps * n_slices;
  if ((bn & 3) == 0) {
    const int bn4 = bn >> 2;
    const size_t stride4 = part_stride >> 2;
    for (int o = threadIdx.x; o < nrows * bn4; o += kThreads) {
      const int i = o / bn4;
      const int n = (o - i * bn4) << 2;
      const float4 b =
          make_float4(bias[n], bias[n + 1], bias[n + 2], bias[n + 3]);
      const float4* p =
          reinterpret_cast<const float4*>(part0 + (size_t)i * bn + n);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int q = 0; q < np; ++q) {
        const float4 u = __ldcg(p + q * stride4);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      out(i, n, activate(v.x + b.x, act));
      out(i, n + 1, activate(v.y + b.y, act));
      out(i, n + 2, activate(v.z + b.z, act));
      out(i, n + 3, activate(v.w + b.w, act));
    }
    return;
  }
  for (int o = threadIdx.x; o < nrows * bn; o += kThreads) {
    const int i = o / bn;
    const int n = o - i * bn;
    const float* p = part0 + (size_t)i * bn + n;
    const float bv = bias[n];
    float v = 0.f;
#pragma unroll 8
    for (int q = 0; q < np; ++q) v += __ldcg(p + q * part_stride);
    out(i, n, activate(v + bv, act));
  }
}

// 5, for a pair run: its partials are [nrows][2 bn], the gate's columns
// and then the up's (part_stride apart, summed in the order q = 0, 1, ...
// as reduce_run sums them); out(i, n, y) stores y = act(gate + bias[n]) *
// (up + bias[bn + n]) for the n < bn outputs of each row.  bn % 4 == 0.
template <typename Out>
__device__ __forceinline__ void reduce_pair_run(const float* part0, int steps,
                                                int n_slices,
                                                size_t part_stride, int nrows,
                                                int bn, const float* bias,
                                                int act, const Out& out) {
  const int np = steps * n_slices;
  const int bn4 = bn >> 2;
  const size_t stride4 = part_stride >> 2;
  for (int o = threadIdx.x; o < nrows * bn4; o += kThreads) {
    const int i = o / bn4;
    const int n = (o - i * bn4) << 2;
    const float4* pg =
        reinterpret_cast<const float4*>(part0 + (size_t)i * 2 * bn + n);
    const float4* pu = pg + bn4;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 u = g;
#pragma unroll 4
    for (int q = 0; q < np; ++q) {
      const float4 a = __ldcg(pg + q * stride4);
      const float4 c = __ldcg(pu + q * stride4);
      g.x += a.x;
      g.y += a.y;
      g.z += a.z;
      g.w += a.w;
      u.x += c.x;
      u.y += c.y;
      u.z += c.z;
      u.w += c.w;
    }
    out(i, n, activate(g.x + bias[n], act) * (u.x + bias[bn + n]));
    out(i, n + 1, activate(g.y + bias[n + 1], act) * (u.y + bias[bn + n + 1]));
    out(i, n + 2, activate(g.z + bias[n + 2], act) * (u.z + bias[bn + n + 2]));
    out(i, n + 3, activate(g.w + bias[n + 3], act) * (u.w + bias[bn + n + 3]));
  }
}

}  // namespace
