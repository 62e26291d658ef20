// The fused ViT block's C entries (forward and backward); the device code is
// vit_block.cuh, its instances fused_vit_block_hd32.cu and _hd64.cu.
#include "vit_block.cuh"

// ptrs: x, 12 weights (VitArgs order), y, 4 transposed (wqkv, wo, w1, w2)
// ints: N, T, W, H, FF, GELU (train_common.cuh:Gelu: 0 exact, 1 quick, 2 poly, 3 bf16)
extern "C" int sd_vit_block_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  VitArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[1 + i]);
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[13]));
  for (int i = 0; i < 4; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[14 + i]);
  a.N = ints[0];
  a.T = ints[1];
  a.W = ints[2];
  a.H = ints[3];
  a.FF = ints[4];
  const int gelu = ints[5];
  const int D = head_dim(a.W, a.H);
  if (D == 0 || a.T < 1 || a.W % 8 || a.FF % 8 || gelu < 0 || gelu > 3)
    return (int)cudaErrorInvalidValue;
  // refused when a frame does not fit one block's shared memory
  const size_t smem = vit_smem_bytes(a.T, a.W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D == 32 ? launch_vit_fwd_hd32(a, gelu, smem, st)
                       : launch_vit_fwd_hd64(a, gelu, smem, st));
}

// ptrs: x, dy, 12 weights, 4 transposed (wqkv, wo, w1, w2), dx,
//       dwqkv (W,3W), dwo (W,W), dw1 (W,FF), dw2 (FF,W), gvec (9W+FF),
//       ws32, wsbf, saved (N*T, 8W+2FF), vpart (N, 9W+FF), tpart
// ints: N, T, W, H, FF, GELU, ws32_stride, wsbf_stride, rows_per_split
extern "C" int sd_vit_block_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  VitBwdArgs a = {};
  auto P = [&](int i) { return const_cast<void*>(ptrs[i]); };
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.dy = static_cast<const bf16*>(ptrs[1]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[2 + i]);
  for (int i = 0; i < 4; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[14 + i]);
  a.dx = static_cast<bf16*>(P(18));
  float* mats[4] = {static_cast<float*>(P(19)), static_cast<float*>(P(20)),
                    static_cast<float*>(P(21)), static_cast<float*>(P(22))};
  float* gvec = static_cast<float*>(P(23));
  a.ws32 = static_cast<float*>(P(24));
  a.wsbf = static_cast<bf16*>(P(25));
  a.saved = static_cast<bf16*>(P(26));
  a.vpart = static_cast<float*>(P(27));
  float* tpart = static_cast<float*>(P(28));
  a.N = ints[0];
  a.T = ints[1];
  a.W = ints[2];
  a.H = ints[3];
  a.FF = ints[4];
  const int gelu = ints[5];
  a.ws32_stride = ints[6];
  a.wsbf_stride = ints[7];
  const int rows_per_split = ints[8];
  const int D = head_dim(a.W, a.H);
  size_t n32, nbf;
  carve(a.T, a.W, a.FF, nullptr, nullptr, nullptr, &n32, &nbf);
  if (D == 0 || a.T < 1 || a.W % 8 || a.FF % 8 || gelu < 0 || gelu > 3 ||
      n32 > (size_t)a.ws32_stride || nbf > (size_t)a.wsbf_stride)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * a.H * a.T * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 32 ? launch_vit_bwd_hd32(a, gelu, smem, st)
                            : launch_vit_bwd_hd64(a, gelu, smem, st);
  if (err != cudaSuccess) return (int)err;
  // weight gradients: (n1, dqkv) (om, da) (n2, dzc) (hg, gc) over the N T rows
  TdotJob jobs[4];
  layer_tdot_jobs(a.saved, a.N * a.T, a.W, a.FF, mats, tpart, rows_per_split, jobs);
  const SumJob vec{a.vpart, gvec, a.N, 9 * a.W + a.FF};
  return launch_weight_grads(jobs, 4, &vec, 1, rows_per_split, st);
}
