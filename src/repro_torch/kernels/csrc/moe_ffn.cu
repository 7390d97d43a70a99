// Hand-written Hopper (sm_90a) kernels for the grouped expert FFN.
//
// They replace the Pallas kernel moe_ffn (src/repro/kernels/moe_ffn.py,
// `moe_ffn` / body `_kernel`): out[e] = act(x[e] @ Wu[e]).astype(x.dtype) @
// Wd[e] over capacity-grouped tokens x [E, C, d], Wu [E, d, f], Wd [E, f, d],
// all f32 or all bf16, with f32 accumulation.  h never goes to device
// memory: that is the kernel's point (moe_ffn.py:5-8).
//
// What bounds it on the H100.  At the expert widths of Granite-3.0-1B-A400M
// (E = 32, d = 1024, f = 512, C = 640) one call does 2 * 2 * E * C * d * f =
// 42.9 GFLOP and moves x, Wu, Wd and the output once: 151 MB in bf16
// (45 us at 3.35 TB/s; the tensor cores need 43 us at 989 TFLOP/s), 302 MB in
// f32 (the f32 FMA rate outside the tensor cores needs 640 us).  Inside the
// card the cost that a design controls is how often each weight tile is
// fetched from L2: once per CTA of its expert.
//
// bf16: moe_bf16_kernel, on the tensor cores.  A CTA of W consumer
// warpgroups owns (expert e, 64 * W token rows), so each weight tile it
// fetches serves 64 * W rows.  For each f-chunk (all of f when h fits in
// shared memory, as at Granite's widths) it
//   1. computes h[:, chunk] = x_tile @ Wu[:, chunk] with
//      wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators in registers),
//      128 columns at a time over K = d in steps of 64; applies the
//      activation, rounds to bf16 as the reference does (moe_ffn.py:38) and
//      writes h into shared memory in the 128-byte-swizzled K-major layout
//      that the second product reads as its A operand;
//   2. computes out[:, n-chunk] += h @ Wd[chunk, n-chunk] for 128-wide
//      n-chunks of d, accumulating in registers, and writes each n-chunk
//      once (in bf16), or, when f takes more than one chunk, carries the
//      CTA's own f32 partial sums in a device scratch between chunks (one
//      CTA owns those rows: no atomics, a deterministic result).
// Operand tiles (x [64 * W, 64], Wu [64, 128], Wd [64, 128]) stream through
// a ring of `stages` shared-memory buffers.  One producer warp beside the
// consumer warpgroups refills each stage as soon as both warpgroups have
// released it (an `empty` mbarrier), one lane issuing TMA copies (3-D
// tensor maps [E, rows, cols], so ragged rows, K and N are zero-filled by
// the hardware and never cross into the next expert) that complete on the
// stage's `full` mbarrier.  Shapes whose rows are not 16-byte multiples,
// which a tensor map cannot describe, take the `loads` route of the same
// kernel: the producer warp copies the tile with bounds-checked loads into
// the same swizzled layout and its 32 lanes arrive on the same barrier.
// The activation runs in a loop specialized on its code (ACT_DISPATCH), so
// the elements' instruction chains interleave.  With bf16 inputs every bf16
// x bf16 product is exact in f32, so this is the reference's arithmetic
// summed in another order.
//
// f32: moe_f32_kernel, plain f32 FMA (no TF32: the reference has no such
// mode).  A CTA of 256 threads owns (expert e, 64 token rows); each thread
// computes an 8 x 4 register tile, reusing each weight value it loads
// across 8 rows and each x or h value across 4 columns.  x and weight tiles
// ([64, 16] and [16, 128]) are double-buffered by cp.async (zero-filled past
// the edges; element-wise copies where a row is not a 16-byte multiple).
// h for one f-chunk lives in shared memory as f32; the chunk is sized so
// that two CTAs fit on an SM, and out's partial sums carry between chunks
// in the device scratch as above.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the first error of the set-up calls).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

// ----------------------------------------------------------------------------
// shared by both kernels
// ----------------------------------------------------------------------------

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ----------------------------------------------------------------------------

constexpr int kMaxStages = 4;
constexpr int kBK = 64;            // K per stage: one 128-byte swizzle row
constexpr int kBN = 128;           // N per product
constexpr int kBTile = kBK * kBN * 2;  // bytes of one [64, 128] bf16 tile
constexpr int kBox = kBK * 64 * 2;     // bytes of one [64, 64] TMA box

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// box {c0 (innermost), c1, c2} of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets lbo, sbo
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Layouts, all 128-byte swizzled in 1024-byte atoms of 8 rows x 128 bytes
// (16-byte chunk q of row r stored at chunk q ^ (r % 8)), as TMA writes them:
//  - A (x tile, or h): [rows, 64] per K-step, K-major; 8-row groups 1024 B
//    apart (SBO); a k16 step moves 32 bytes along the row.
//  - B (Wu or Wd tile [64 K-rows, 128 N-cols]): two boxes of [64, 64], the
//    second 8192 B after the first; MN-major: 64 N-columns per 128-byte row,
//    the next 64 columns LBO = 8192 B on, the next 8 K-rows SBO = 1024 B on;
//    a k16 step moves 16 rows = 2048 bytes.
constexpr uint32_t kA_SBO = 1024;
constexpr uint32_t kB_LBO = kBox;
constexpr uint32_t kB_SBO = 1024;

// byte offset of element (r, c), c < 64, in a swizzled [rows, 64] bf16 tile
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1);
}
// D[64 x 128] (f32, registers) += A[64 x 16] * B[16 x 128] with bf16
// operands in shared memory: A K-major, B MN-major (imm-trans-b = 1).  D is
// replaced rather than added to when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// one step of the bf16 kernel's walk: chunk of f, product, N block, K step
struct Job {
  int fh0;    // first f column of the chunk
  int phase;  // 1: h = x @ Wu[:, chunk]; 2: out += h @ Wd[chunk, :]
  int n;      // 128-wide N block of the product
  int kb;     // 64-deep K step
};

struct Walk {
  int fc, kd, n1c, n2c, kf, per_chunk;
  __device__ Walk(int d, int fc_) : fc(fc_) {
    const int fc_pad = round_up(fc, kBK);
    kd = ceil_div(d, kBK);
    n1c = ceil_div(fc_pad, kBN);
    n2c = ceil_div(d, kBN);
    kf = fc_pad / kBK;
    per_chunk = n1c * kd + n2c * kf;
  }
  __device__ Job operator()(int j) const {
    Job jb;
    const int ch = j / per_chunk;
    int r = j - ch * per_chunk;
    jb.fh0 = ch * fc;
    if (r < n1c * kd) {
      jb.phase = 1;
      jb.n = r / kd;
      jb.kb = r - jb.n * kd;
    } else {
      r -= n1c * kd;
      jb.phase = 2;
      jb.n = r / kf;
      jb.kb = r - jb.n * kf;
    }
    return jb;
  }
};

// [64, 128] tile of the row-major [nrows, ncols] matrix w from (r0, c0),
// zero past its edges, into the two swizzled [64, 64] boxes at dst
__device__ void copy_b_tile(uint8_t* dst, const unsigned short* w, int nrows,
                            int ncols, int r0, int c0, int t, int nthreads) {
  for (int i = t; i < kBK * kBN; i += nthreads) {
    const int r = i >> 7;
    const int c = i & 127;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const unsigned short v =
        gr < nrows && gc < ncols ? w[(size_t)gr * ncols + gc] : 0;
    *reinterpret_cast<unsigned short*>(dst + (c >> 6) * kBox +
                                       swz(r, c & 63)) = v;
  }
}

// CALL<A> args for the activation code act, with A a compile-time
// constant: a loop of activations then has no branch on act inside, so the
// compiler interleaves the elements' independent instruction chains
#define ACT_DISPATCH(act, CALL, ARGS)          \
  switch (act) {                               \
    case kRelu: CALL<kRelu> ARGS; break;       \
    case kGelu: CALL<kGelu> ARGS; break;       \
    case kTanh: CALL<kTanh> ARGS; break;       \
    case kSigmoid: CALL<kSigmoid> ARGS; break; \
    case kSilu: CALL<kSilu> ARGS; break;       \
    case kSquaredRelu: CALL<kSquaredRelu> ARGS; break; \
    default: CALL<kNone> ARGS; break;          \
  }

// h[:, col0 + ...] = act(acc) in bf16, into the swizzled [rows, 64] tiles
// of h (a_tile bytes apart), for the columns below fc_pad
template <int A>
__device__ __forceinline__ void write_h(const float (&acc)[64], uint8_t* hs,
                                        int a_tile, int row_base, int col0,
                                        int fc_pad) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row_base + 8 * ((i >> 1) & 1);
    const int col = col0 + 8 * (i >> 2);
    if (col < fc_pad) {
      *reinterpret_cast<__nv_bfloat162*>(
          hs + (col >> 6) * a_tile + swz(row, col & 63)) =
          __floats2bfloat162_rn(activate(acc[i], A), activate(acc[i + 1], A));
    }
  }
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// x, out [E, C, d]; w_up [E, d, f]; w_down [E, f, d]; scratch [E, C, d] f32
// (only when f spans more than one chunk of fc columns).  Threads: W
// consumer warpgroups, then one producer warp.
template <int W>
__global__ void __launch_bounds__(128 * W + 32)
    moe_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_wu,
                    const __grid_constant__ CUtensorMap tm_wd,
                    const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w_up,
                    const __nv_bfloat16* __restrict__ w_down,
                    __nv_bfloat16* __restrict__ out, float* scratch, int C,
                    int d, int f, int fc, int stages, int use_tma, int act) {
  constexpr int BM = 64 * W;
  constexpr int kConsumers = 128 * W;
  constexpr int kATile = BM * 128;  // bytes of one [BM, 64] bf16 A tile
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = kATile + kBTile;
  uint8_t* hs = base + stages * stage_bytes;  // fc_pad / 64 A tiles of h
  const int e = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  const Walk walk(d, fc);
  const int n_chunks = ceil_div(f, fc);
  const int n_jobs = n_chunks * walk.per_chunk;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], use_tma ? 1 : 32);
      mbar_init(&empty[s], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index, read from lane 0, so that the compiler knows every
  // branch on it is uniform across the warp (wgmma in a path the compiler
  // takes for divergent gets serialized)
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  if (warp >= 4 * W) {
    // the producer warp: fills stage j % stages once its consumers are done
    // with the job that used it before
    const int lane = t - kConsumers;
    const unsigned short* xe =
        reinterpret_cast<const unsigned short*>(x) + (size_t)e * C * d;
    const unsigned short* wue =
        reinterpret_cast<const unsigned short*>(w_up) + (size_t)e * d * f;
    const unsigned short* wde =
        reinterpret_cast<const unsigned short*>(w_down) + (size_t)e * f * d;
    for (int j = 0; j < n_jobs; ++j) {
      const Job jb = walk(j);
      const int s = j % stages;
      if (j >= stages) mbar_wait(&empty[s], ((j / stages) - 1) & 1);
      uint8_t* a = base + s * stage_bytes;
      uint8_t* b = a + kATile;
      if (use_tma) {
        if (lane != 0) continue;
        if (jb.phase == 1) {
          const int n = jb.fh0 + jb.n * kBN;
          mbar_expect_tx(&full[s], kATile + kBTile);
          tma_load(a, &tm_x, &full[s], jb.kb * kBK, m0, e);
          tma_load(b, &tm_wu, &full[s], n, jb.kb * kBK, e);
          tma_load(b + kBox, &tm_wu, &full[s], n + 64, jb.kb * kBK, e);
        } else {
          const int k = jb.fh0 + jb.kb * kBK;
          mbar_expect_tx(&full[s], kBTile);
          tma_load(b, &tm_wd, &full[s], jb.n * kBN, k, e);
          tma_load(b + kBox, &tm_wd, &full[s], jb.n * kBN + 64, k, e);
        }
        continue;
      }
      if (jb.phase == 1) {
        for (int i = lane; i < BM * kBK; i += 32) {
          const int r = i >> 6;
          const int c = i & 63;
          const int gr = m0 + r;
          const int gk = jb.kb * kBK + c;
          *reinterpret_cast<unsigned short*>(a + swz(r, c)) =
              gr < C && gk < d ? xe[(size_t)gr * d + gk] : 0;
        }
        copy_b_tile(b, wue, d, f, jb.kb * kBK, jb.fh0 + jb.n * kBN, lane,
                    32);
      } else {
        copy_b_tile(b, wde, f, d, jb.fh0 + jb.kb * kBK, jb.n * kBN, lane,
                    32);
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile
  const int wg = warp >> 2;
  const int lane = t & 31;
  const bool signaller = (t & 127) == 0;
  const int row_base = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col_base = 2 * (lane & 3);
  const int fc_pad = round_up(fc, kBK);
  int j = 0;  // the job this thread consumes next, in the producer's order

  // one product: kn K-steps of 64 into acc, from 0; frees each stage as
  // soon as it is read.  Only wgmma writes acc before the final wait, so
  // the compiler need not serialize the asynchronous products.
  auto product = [&](float (&acc)[64], int kn, const uint8_t* a_h) {
    wgmma_fence();
    for (int kb = 0; kb < kn; ++kb, ++j) {
      const int s = j % stages;
      mbar_wait(&full[s], (j / stages) & 1);
      const uint8_t* a = base + s * stage_bytes;
      const uint8_t* a_op =
          (a_h == nullptr ? a : a_h + kb * kATile) + wg * 64 * 128;
      const uint8_t* b = a + kATile;
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        wgmma_m64n128k16(acc, gmma_desc(a_op + 32 * k, 16, kA_SBO),
                         gmma_desc(b + 2048 * k, kB_LBO, kB_SBO),
                         kb > 0 || k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous K-step's products are done
      if (kb > 0 && signaller) mbar_arrive(&empty[(j - 1) % stages]);
    }
    wgmma_wait<0>();
    if (signaller) mbar_arrive(&empty[(j - 1) % stages]);
  };

  for (int c = 0; c < n_chunks; ++c) {
    const int fh0 = c * fc;
    // 1. h[:, chunk] = act(x_tile @ Wu[:, chunk]), 128 columns at a time
    for (int n = 0; n < walk.n1c; ++n) {
      float acc[64];
      product(acc, walk.kd, nullptr);
      uint8_t* hn = hs;
      const int col0 = n * kBN + col_base;
      ACT_DISPATCH(act, write_h, (acc, hn, kATile, row_base, col0, fc_pad));
    }
    fence_proxy_async();  // h, written by this warpgroup, read by its wgmma
    wg_barrier(1 + wg);
    // 2. out[:, 128-column block] (+)= h @ Wd[chunk, block]
    const bool final_chunk = fh0 + fc >= f;
    const bool pairs = (d & 1) == 0;  // (col, col + 1) both in or both out
    for (int n = 0; n < walk.n2c; ++n) {
      float acc[64];
      product(acc, walk.kf, hs);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = m0 + row_base + 8 * ((i >> 1) & 1);
        const int col = n * kBN + 8 * (i >> 2) + col_base;
        if (row >= C || col >= d) continue;
        const size_t o = ((size_t)e * C + row) * d + col;
        const bool second = col + 1 < d;
        float v0 = acc[i];
        float v1 = acc[i + 1];
        if (c > 0) {  // earlier chunks' sums: this CTA's own, from scratch
          v0 += scratch[o];
          if (second) v1 += scratch[o + 1];
        }
        if (final_chunk && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(v0, v1);
        } else if (final_chunk) {
          out[o] = __float2bfloat16(v0);
          if (second) out[o + 1] = __float2bfloat16(v1);
        } else {
          scratch[o] = v0;
          if (second) scratch[o + 1] = v1;
        }
      }
    }
  }
}

// ----------------------------------------------------------------------------
// f32: cp.async double buffering and an 8 x 4 register tile per thread
// ----------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 64;  // token rows per CTA
constexpr int kF32BK = 16;    // K per staged tile
constexpr int kF32BN = 128;   // N per product

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// [R, CC] tile of the row-major [nrows, ncols] matrix m from (r0, c0) into
// dst (row stride CC), zero past its edges; 16-byte copies when Vec
template <bool Vec, int R, int CC>
__device__ __forceinline__ void stage_tile(float* dst, const float* m,
                                           int nrows, int ncols, int r0,
                                           int c0) {
  if (Vec) {
    for (int i = threadIdx.x; i < R * CC / 4; i += kF32Threads) {
      const int r = i / (CC / 4);
      const int c = (i - r * (CC / 4)) * 4;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async16(dst + r * CC + c,
                 ok ? m + (size_t)(r0 + r) * ncols + c0 + c : m, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * CC; i += kF32Threads) {
      const int r = i / CC;
      const int c = i - r * CC;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async4(dst + i, ok ? m + (size_t)(r0 + r) * ncols + c0 + c : m, ok);
    }
  }
}

// acc[i][q] += sum_k a[(ty*8+i) * lda + k] * b[k * kF32BN + tx*4 + q] over
// the kF32BK columns of a and rows of b
__device__ __forceinline__ void fma_tile(float (&acc)[8][4], const float* a,
                                         int lda, const float* b, int ty,
                                         int tx) {
#pragma unroll
  for (int kk = 0; kk < kF32BK; kk += 4) {
    float4 av[8];
    float4 bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 8 + i) * lda + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bv[q] = *reinterpret_cast<const float4*>(b + (kk + q) * kF32BN + tx * 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][0] = fmaf(ak[q], bv[q].x, acc[i][0]);
        acc[i][1] = fmaf(ak[q], bv[q].y, acc[i][1]);
        acc[i][2] = fmaf(ak[q], bv[q].z, acc[i][2]);
        acc[i][3] = fmaf(ak[q], bv[q].w, acc[i][3]);
      }
    }
  }
}

// act(acc) into 8 rows of h, row stride ld floats, 4 columns each
template <int A>
__device__ __forceinline__ void write_h_f32(const float (&acc)[8][4],
                                            float* h, int ld) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<float4*>(h + i * ld) =
        make_float4(activate(acc[i][0], A), activate(acc[i][1], A),
                    activate(acc[i][2], A), activate(acc[i][3], A));
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kF32Threads, 2)
    moe_f32_kernel(const float* __restrict__ x, const float* __restrict__ w_up,
                   const float* __restrict__ w_down, float* __restrict__ out,
                   float* scratch, int C, int d, int f, int fc, int act) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);    // [2][64][16]
  float* bs = as + 2 * kF32Rows * kF32BK;         // [2][16][128]
  float* hs = bs + 2 * kF32BK * kF32BN;           // [64][fc_pad]
  const int fc_pad = round_up(fc, kF32BK);
  const int e = blockIdx.y;
  const int m0 = blockIdx.x * kF32Rows;
  const int ty = threadIdx.x >> 5;  // rows ty*8 .. ty*8+7
  const int tx = threadIdx.x & 31;  // columns tx*4 .. tx*4+3
  const float* xe = x + ((size_t)e * C + m0) * d;
  const float* wue = w_up + (size_t)e * d * f;
  const float* wde = w_down + (size_t)e * f * d;
  const int rows = C - m0;
  float acc[8][4];

  for (int fh0 = 0; fh0 < f; fh0 += fc) {
    // 1. h[:, chunk] = act(x_tile @ Wu[:, chunk]), 128 columns at a time
    for (int n1 = 0; n1 < fc_pad; n1 += kF32BN) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      const int nk = ceil_div(d, kF32BK);
      stage_tile<Vec, kF32Rows, kF32BK>(as, xe, rows, d, 0, 0);
      stage_tile<Vec, kF32BK, kF32BN>(bs, wue, d, f, 0, fh0 + n1);
      cp_async_commit();
      for (int kt = 0; kt < nk; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < nk) {
          const int k0 = (kt + 1) * kF32BK;
          stage_tile<Vec, kF32Rows, kF32BK>(as + (buf ^ 1) * kF32Rows * kF32BK,
                                            xe, rows, d, 0, k0);
          stage_tile<Vec, kF32BK, kF32BN>(bs + (buf ^ 1) * kF32BK * kF32BN,
                                          wue, d, f, k0, fh0 + n1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        fma_tile(acc, as + buf * kF32Rows * kF32BK, kF32BK,
                 bs + buf * kF32BK * kF32BN, ty, tx);
        __syncthreads();
      }
      const int col = n1 + tx * 4;
      if (col < fc_pad) {
        float* hrow = hs + ty * 8 * fc_pad + col;
        ACT_DISPATCH(act, write_h_f32, (acc, hrow, fc_pad));
      }
    }
    __syncthreads();  // h of the chunk complete
    // 2. out[:, n2 block] += h @ Wd[chunk, n2 block]
    const bool final_chunk = fh0 + fc >= f;
    for (int n2 = 0; n2 < d; n2 += kF32BN) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = m0 + ty * 8 + i;
          const int col = n2 + tx * 4 + q;
          acc[i][q] = fh0 > 0 && row < C && col < d
                          ? scratch[((size_t)e * C + row) * d + col]
                          : 0.f;
        }
      }
      const int nk = fc_pad / kF32BK;
      stage_tile<Vec, kF32BK, kF32BN>(bs, wde, f, d, fh0, n2);
      cp_async_commit();
      for (int kt = 0; kt < nk; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < nk) {
          stage_tile<Vec, kF32BK, kF32BN>(bs + (buf ^ 1) * kF32BK * kF32BN,
                                          wde, f, d, fh0 + (kt + 1) * kF32BK,
                                          n2);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        fma_tile(acc, hs + kt * kF32BK, fc_pad, bs + buf * kF32BK * kF32BN,
                 ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty * 8 + i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = n2 + tx * 4 + q;
          if (row < C && col < d) {
            const size_t o = ((size_t)e * C + row) * d + col;
            if (final_chunk) {
              out[o] = acc[i][q];
            } else {
              scratch[o] = acc[i][q];
            }
          }
        }
      }
    }
    __syncthreads();  // h is rewritten by the next chunk
  }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// bf16 [outer, mid, inner] (inner contiguous), boxes of [1, box_mid, 64]
cudaError_t tensor_map(EncodeTiled encode, CUtensorMap* map, const void* p,
                       int outer, int mid, int inner, int box_mid) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * mid * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_mid, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

size_t bf16_smem(int rows, int stages, int fc) {
  return 1024 + (size_t)stages * (rows * 128 + kBTile) +
         (size_t)rows * round_up(fc, kBK) * 2;
}

size_t f32_smem(int fc) {
  return sizeof(float) * (2 * kF32Rows * kF32BK + 2 * kF32BK * kF32BN +
                          (size_t)kF32Rows * round_up(fc, kF32BK));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch_bf16(const void* x, const void* w_up, const void* w_down,
                        void* out, float* scratch, int E, int C, int d, int f,
                        int rows, int stages, int fc, int use_tma, int act,
                        cudaStream_t stream) {
  if ((rows != 64 && rows != 128) || stages < 2 || stages > kMaxStages ||
      fc < 1)
    return cudaErrorInvalidValue;
  CUtensorMap mx = {}, mu = {}, md = {};
  if (use_tma) {
    EncodeTiled encode;
    cudaError_t err = encoder(&encode);
    if (err != cudaSuccess) return err;
    if ((err = tensor_map(encode, &mx, x, E, C, d, rows)) != cudaSuccess ||
        (err = tensor_map(encode, &mu, w_up, E, d, f, kBK)) != cudaSuccess ||
        (err = tensor_map(encode, &md, w_down, E, f, d, kBK)) != cudaSuccess)
      return err;
  }
  const size_t smem = bf16_smem(rows, stages, fc);
  const dim3 grid(ceil_div(C, rows), E);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ub = static_cast<const __nv_bfloat16*>(w_up);
  const auto* db = static_cast<const __nv_bfloat16*>(w_down);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (rows == 128) {
    if ((err = allow_smem(moe_bf16_kernel<2>, smem)) != cudaSuccess) return err;
    moe_bf16_kernel<2><<<grid, 256 + 32, smem, stream>>>(
        mx, mu, md, xb, ub, db, ob, scratch, C, d, f, fc, stages, use_tma,
        act);
  } else {
    if ((err = allow_smem(moe_bf16_kernel<1>, smem)) != cudaSuccess) return err;
    moe_bf16_kernel<1><<<grid, 128 + 32, smem, stream>>>(
        mx, mu, md, xb, ub, db, ob, scratch, C, d, f, fc, stages, use_tma,
        act);
  }
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w_up, const void* w_down,
                       void* out, float* scratch, int E, int C, int d, int f,
                       int rows, int fc, int vec, int act,
                       cudaStream_t stream) {
  if (rows != kF32Rows || fc < 1) return cudaErrorInvalidValue;
  const size_t smem = f32_smem(fc);
  const dim3 grid(ceil_div(C, kF32Rows), E);
  const auto* xf = static_cast<const float*>(x);
  const auto* uf = static_cast<const float*>(w_up);
  const auto* df = static_cast<const float*>(w_down);
  auto* of = static_cast<float*>(out);
  cudaError_t err;
  if (vec) {
    if ((err = allow_smem(moe_f32_kernel<true>, smem)) != cudaSuccess)
      return err;
    moe_f32_kernel<true><<<grid, kF32Threads, smem, stream>>>(
        xf, uf, df, of, scratch, C, d, f, fc, act);
  } else {
    if ((err = allow_smem(moe_f32_kernel<false>, smem)) != cudaSuccess)
      return err;
    moe_f32_kernel<false><<<grid, kF32Threads, smem, stream>>>(
        xf, uf, df, of, scratch, C, d, f, fc, act);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w_up, w_down and out all of it).  rows:
// token rows per CTA; stages: the bf16 ring's depth; f_chunk: f columns
// whose h one CTA keeps in shared memory at a time (scratch [E, C, d] f32
// must be given when f_chunk < f); route: 0 TMA (bf16) or 16-byte cp.async
// (f32), 1 bounds-checked loads (bf16) or 4-byte cp.async (f32).
extern "C" int moe_ffn_launch(int dtype, const void* x, const void* w_up,
                              const void* w_down, void* out, float* scratch,
                              int E, int C, int d, int f, int rows,
                              int stages, int f_chunk, int route, int act,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_chunk < f && scratch == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_f32(x, w_up, w_down, out, scratch, E, C, d, f, rows,
                             f_chunk, route == 0, act, s);
    case 1:
      return (int)launch_bf16(x, w_up, w_down, out, scratch, E, C, d, f,
                              rows, stages, f_chunk, route == 0, act, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
