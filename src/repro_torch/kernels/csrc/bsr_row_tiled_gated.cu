// The megakernel's row-tiled walk, gated (Gate = true), in a unit of its
// own so that nvcc builds it beside the ungated one: the launcher that
// bsr_megakernel_prepared_launch (bsr_kernels.cu) calls for a row-tiled
// launch block with gate.  The kernel, its design and what bounds it:
// row_tile.cuh.

#include "row_tile.cuh"

cudaError_t mega::row_tiled_gated(const Block& b, const Call& c, int* grid) {
  return row_tiled_walk<true>(b, c, grid);
}
