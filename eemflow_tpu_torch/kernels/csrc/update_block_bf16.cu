// K5's conv kernel in its bf16 operand mode (mma m16n8k16 bf16, float32 sums),
// compiled apart from the other mode so that nvcc builds both at once.  The
// kernel is in update_block.cuh, the design note in update_block.cu.

#include "update_block.cuh"

namespace k5 {

K5_DEFINE_MODE(bf16, true)

}  // namespace k5
