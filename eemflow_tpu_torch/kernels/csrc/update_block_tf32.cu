// K5's conv kernel in its float32 operand mode (split TF32 on mma m16n8k8),
// compiled apart from the other mode so that nvcc builds both at once.  The
// kernel is in update_block.cuh, the design note in update_block.cu.

#include "update_block.cuh"

namespace k5 {

K5_DEFINE_MODE(tf32, false)

}  // namespace k5
