// What the megakernel's two walks share, on the host and on the device:
// the split-K walk (split_k.cuh, launched from bsr_kernels.cu) and the
// row-tiled walk (row_tile.cuh, launched from bsr_row_tiled.cu and
// bsr_row_tiled_gated.cu).  bsr_matmul.cu takes the row chunk and the dtype
// dispatch from here too, through split_k.cuh.
//
// The megakernel's one host interface is its launch block (mega::Block):
// bsr_megakernel_prepare (bsr_kernels.cu) checks and packs what a flat
// schedule's launches share, and bsr_megakernel_prepared_launch checks each
// call's own values (mega::Call) and hands both to the walk's launcher.
// The two types live in a named namespace because they cross translation
// units; a type in an anonymous namespace differs in each unit.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

#include "common.cuh"

namespace {

// batch rows of a split-K work item, and of an occupancy slot's chunk on
// both walks (kernels/bsr_matmul.py's _ROWS_PER_CTA)
constexpr int kChunkRows = 32;
constexpr int kMaxLayers = 32;  // a walk's layer table travels by value
constexpr int kMaxDevices = 16;

// the count of a slot this launch wrote, or -1 for a stale one
__device__ __forceinline__ int slot_count(unsigned long long v,
                                          unsigned epoch) {
  return (unsigned)(v >> 32) == epoch ? (int)(unsigned)v : -1;
}

// Gate, once every hidden layer's slots are final, by one CTA of Threads
// threads: the returned occupancy p.occ [max(1, n_layers-1), hidden_tiles],
// the sum over the chunks of this launch's slots (0 for tiles no layer
// writes: their slots carry another epoch).  P: either walk's parameters.
template <int Threads, typename P>
__device__ __forceinline__ void sum_occupancy(const P& p, int chunks) {
  const int n_occ = max(1, p.n_layers - 1);
  for (int e = threadIdx.x; e < n_occ * p.hidden_tiles; e += Threads) {
    int sum = 0;
    for (int j = 0; j < chunks; ++j)
      sum += max(0, slot_count(__ldcg(p.slots + (size_t)e * chunks + j),
                               p.epoch));
    p.occ[e] = sum;
  }
}

// The co-resident CTA count of one kernel instance of Threads threads at
// one dynamic shared-memory size, and its shared-memory attribute, set and
// queried once per device rather than on every call.
template <auto Kernel, int Threads>
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
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      Threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas = per_sm * sms;
  if (c != nullptr) *c = Cap{smem, *ctas};
  return cudaSuccess;
}

// One cooperative launch of Kernel (Threads threads a CTA, smem bytes of
// dynamic shared memory) on p: one CTA per work item, at most the
// co-resident CTAs (a cooperative launch requires it) and at least one.
// *grid receives the grid size.  Returns cudaGetLastError() or the launch
// API's own error.
template <auto Kernel, int Threads, typename P>
cudaError_t launch_cooperative(P p, int items, size_t smem,
                               cudaStream_t stream, int* grid) {
  int ctas = 0;
  cudaError_t err = coresident_ctas<Kernel, Threads>(smem, &ctas);
  if (err != cudaSuccess) return err;
  *grid = max(1, min(items, ctas));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)Kernel, dim3(*grid),
                                    dim3(Threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// weight elements of one 16-byte load
template <typename WT>
constexpr int kVec = 16 / (int)sizeof(WT);

// vec, the weight elements a thread loads at once: 1, or kVec of w_dtype's
inline bool vec_ok(int vec, int w_dtype) {
  return vec == 1 || vec * (w_dtype == 0 ? 4 : w_dtype == 1 ? 2 : 1) == 16;
}

template <typename XT, typename F>
cudaError_t with_w_dtype(int w_dtype, F& f) {
  switch (w_dtype) {
    case 0: return f(Type<XT>{}, Type<float>{});
    case 1: return f(Type<XT>{}, Type<__nv_bfloat16>{});
    case 2: return f(Type<XT>{}, Type<__nv_fp8_e4m3>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(Type<XT>{}, Type<WT>{}) for x_dtype 0 float32, 1 bfloat16 and w_dtype
// 0 float32, 1 bfloat16, 2 float8_e4m3fn (kernels/bsr_matmul.py's _X_CODES
// and _W_CODES); cudaErrorInvalidValue for any other code
template <typename F>
cudaError_t with_dtypes(int x_dtype, int w_dtype, F&& f) {
  switch (x_dtype) {
    case 0: return with_w_dtype<float>(w_dtype, f);
    case 1: return with_w_dtype<__nv_bfloat16>(w_dtype, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace mega {

// What a flat schedule's launches share, for one walk, x dtype and width
// (see bsr_megakernel_prepare); a walk ignores the other walk's fields.
struct Block {
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
  // the gate/up pair layers, a bit per layer (0: none), and where each
  // layer's weights start: step g of layer k at unit unit_off[k] + g, or
  // unit_off[k] + 2 g in a pair layer, whose steps hold [bs, 2 bs] (a unit
  // is bs * bs weights)
  unsigned pair_layers;
  int unit_off[kMaxLayers];
};

// One launch's own values (see bsr_megakernel_prepared_launch).
struct Call {
  const void* x;
  void* out;
  float* scratch;
  int B;
  cudaStream_t stream;
  int* arrivals;  // split-K
  // gated when occ is not null
  const int* occ0;
  unsigned long long* slots;
  int* occ;
  unsigned epoch;
};

// The row-tiled walk's launchers, ungated (bsr_row_tiled.cu) and gated
// (bsr_row_tiled_gated.cu), on a block and a call that
// bsr_megakernel_prepare and bsr_megakernel_prepared_launch have checked.
// Each stores the cooperative grid size in *grid.
cudaError_t row_tiled(const Block& b, const Call& c, int* grid);
cudaError_t row_tiled_gated(const Block& b, const Call& c, int* grid);

}  // namespace mega
