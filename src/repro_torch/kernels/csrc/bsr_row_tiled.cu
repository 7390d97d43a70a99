// The megakernel's row-tiled route, ungated: the C entry that
// bsr_megakernel (kernels/bsr_matmul.py) calls for a large batch without
// gate.  The kernel, its design and what bounds it: row_tile.cuh.

#include "row_tile.cuh"

extern "C" int bsr_megakernel_row_tiled_launch(BSR_ROW_TILED_ARGS) {
  return row_tiled_launch<false>(BSR_ROW_TILED_CALL);
}
