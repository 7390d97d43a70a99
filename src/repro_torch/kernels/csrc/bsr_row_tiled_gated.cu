// The megakernel's row-tiled route, gated (Gate = true), in a unit of its
// own so that nvcc builds it beside the ungated one: the C entry that
// bsr_megakernel (kernels/bsr_matmul.py) calls for a large batch with
// gate=True.  The kernel, its design and what bounds it: row_tile.cuh.

#include "row_tile.cuh"

extern "C" int bsr_megakernel_row_tiled_gated_launch(BSR_ROW_TILED_ARGS) {
  return row_tiled_launch<true>(BSR_ROW_TILED_CALL);
}
