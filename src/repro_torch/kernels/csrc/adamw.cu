// Fused AdamW update: one pass over the leaves of a group, for sm_90a.
//
// What it stands for.  The reference's train step runs under jax.jit, and
// XLA fuses repro.optim.adamw.adamw_update (src/repro/optim/adamw.py:55)
// into a few elementwise passes.  No Pallas kernel exists for it; this is
// the port's counterpart of that fusion.  The eager plain version
// (repro_torch.kernels.adamw.adamw_plain) runs 17 torch._foreach_* passes
// per group, each reading and writing whole f32 tensors.
//
// What it computes, per element in f32, with the plain version's order and
// rounding (correctly rounded __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn, never contracted into an FMA), so the two agree
// bit for bit:
//    g = grad*scale; mu = mu*b1 + g*(1-b1); gg = (g*(1-b2))*g;
//    nu = nu*b2 + gg; den = sqrt(nu/bc2) + eps; upd = (mu/bc1)/den;
//    upd = (upd + m*wd)*lr; m = m - upd; param = m in its dtype (bf16
//    rounded to nearest even, or f32).
// scale, lr, bc1 and bc2 are 0-d f32 tensors on the device (the clip and
// the schedule, computed there): the kernel reads them, the host never does.
//
// What bounds it on the H100: memory.  It reads grad, master, mu and nu
// (16 B an element) and writes master, mu, nu and the parameter (12 B + 2 B
// for bf16, + 4 B for f32), against some 30 flops: about 0.5 flop a byte,
// far below the card's ~20 f32 flops per byte.  For granite-moe-1b-a400m
// (1.34e9 parameters, bf16) that is ~40 GB a step, 12 ms at 3.35 TB/s.
//
// What the design does about it: every byte moves once.  One launch per
// group of leaves (multi-tensor style): the wrapper packs each leaf's
// pointers, element count, output dtype and first chunk into a table in
// device memory; CTA b finds its leaf by a binary search over the first
// chunks and streams one chunk of kChunk elements of it, threads on
// consecutive elements, so every warp's loads and stores are coalesced.
// No temporaries: the moments and the master are updated in place and the
// new parameter is written in its own dtype in the same pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
// elements per CTA; keep in step with repro_torch/kernels/adamw.py
constexpr long long kChunk = (long long)kThreads * kPerThread;

// one leaf of a group, as the wrapper packs it: 8 int64 words
struct Leaf {
  const float* grad;
  float* master;
  float* mu;
  float* nu;
  void* out;          // the new parameter: bf16 or f32
  long long n;        // elements
  long long out_bf16; // 1: out is bf16, 0: f32
  long long chunk0;   // the group's index of this leaf's first chunk
};
static_assert(sizeof(Leaf) == 64, "the wrapper packs 8 words per leaf");

__global__ void __launch_bounds__(kThreads) adamw_kernel(
    const Leaf* __restrict__ leaves, int n_leaves,
    const float* __restrict__ scale_p, const float* __restrict__ lr_p,
    const float* __restrict__ bc1_p, const float* __restrict__ bc2_p,
    float b1, float omb1, float b2, float omb2, float eps, float wd) {
  // this CTA's leaf: the last one whose first chunk is <= blockIdx.x
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  const long long start = (b - leaf.chunk0) * kChunk;
  const long long end = min(start + kChunk, leaf.n);
  const float scale = *scale_p, lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float g = __fmul_rn(leaf.grad[i], scale);
    float mu = __fmul_rn(leaf.mu[i], b1);
    mu = __fadd_rn(mu, __fmul_rn(g, omb1));
    float gg = __fmul_rn(g, omb2);
    gg = __fmul_rn(gg, g);
    float nu = __fmul_rn(leaf.nu[i], b2);
    nu = __fadd_rn(nu, gg);
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), eps);
    float upd = __fdiv_rn(__fdiv_rn(mu, bc1), den);
    float m = leaf.master[i];
    upd = __fadd_rn(upd, __fmul_rn(m, wd));
    upd = __fmul_rn(upd, lr);
    m = __fsub_rn(m, upd);
    leaf.mu[i] = mu;
    leaf.nu[i] = nu;
    leaf.master[i] = m;
    if (leaf.out_bf16)
      reinterpret_cast<__nv_bfloat16*>(leaf.out)[i] = __float2bfloat16_rn(m);
    else
      reinterpret_cast<float*>(leaf.out)[i] = m;
  }
}

}  // namespace

// One launch over the n_leaves leaves of `leaves` (a device table of Leaf
// records, n_chunks chunks in all) on `stream`.  Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int adamw_launch(const void* leaves, int n_leaves,
                            long long n_chunks, const void* scale,
                            const void* lr, const void* bc1, const void* bc2,
                            float b1, float omb1, float b2, float omb2,
                            float eps, float wd, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0) return 0;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  adamw_kernel<<<(unsigned)n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Leaf*>(leaves), n_leaves,
      static_cast<const float*>(scale), static_cast<const float*>(lr),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2), b1,
      omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
