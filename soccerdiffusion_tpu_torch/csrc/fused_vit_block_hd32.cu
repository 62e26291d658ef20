// The fused ViT block's head_dim-32 instances (vit_block.cuh): forward and
// backward under each of the four GELUs, compiled beside the other head dim's.
#include "vit_block.cuh"

namespace sd {

cudaError_t launch_vit_fwd_hd32(const VitArgs& a, int gelu, size_t smem, cudaStream_t st) {
  return launch_vit_fwd_impl<32>(a, gelu, smem, st);
}

cudaError_t launch_vit_bwd_hd32(const VitBwdArgs& a, int gelu, size_t smem, cudaStream_t st) {
  return launch_vit_bwd_impl<32>(a, gelu, smem, st);
}

}  // namespace sd
