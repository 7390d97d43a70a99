// The megakernel's row-tiled walk, ungated: the launcher that
// bsr_megakernel_prepared_launch (bsr_kernels.cu) calls for a row-tiled
// launch block without gate.  The kernel, its design and what bounds it:
// row_tile.cuh.

#include "row_tile.cuh"

cudaError_t mega::row_tiled(const Block& b, const Call& c, int* grid) {
  return row_tiled_walk<false>(b, c, grid);
}
