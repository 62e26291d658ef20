// Shared device helpers for the serving and training kernels (sm_90a).
//
// Conventions of every kernel in this directory:
//   * weights, biases, LayerNorm params and context tokens are bf16 in
//     global memory; arithmetic is fp32;
//   * the residual stream stays fp32 in shared memory;
//   * every matmul input (LayerNorm output, attention output, GELU output)
//     and q / k / v are rounded to bf16 (round-to-nearest-even), so a
//     product is exactly a bf16 x bf16 product and sums accumulate in fp32
//     -- the same rounding points as the plain PyTorch versions beside the
//     kernels;
//   * attention: fp32 scores and softmax, probabilities rounded to bf16
//     after normalisation, fp32 value sums;
//   * the head dimension D is a template parameter, 32 or 64 (head_dim()
//     below; the decoder pass also 128, decoder_pass.cuh:pass_head_dim; the
//     encoder stack also 16, fused_encoder_stack.cu:stack_head_dim); the
//     attention scale is 1 / sqrt(D).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstddef>

namespace sd {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kLnEps = 1e-6f;

// 1 / sqrt(D), the attention scale at head_dim D
template <int D>
__host__ __device__ constexpr float attn_scale() {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the kernels take head_dim 16 (the encoder stack), 32, 64 or 128");
  return D == 16 ? 0.25f : D == 32 ? 0.17677669529663687f : D == 64 ? 0.125f
                                                                  : 0.08838834764831845f;
}

// The head dimension E / H if a kernel instance exists for it (32 or 64), else 0.
__host__ __device__ inline int head_dim(int E, int H) {
  return (H > 0 && (E == 32 * H || E == 64 * H)) ? E / H : 0;
}

__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tof(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Epilogues of the products (mma.cuh, decoder_pass.cuh): called once per
// output element with the fp32 sum (bias included).
struct StoreRoundBf16 {  // bf16 out[m][n] = v
  bf16* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = __float2bfloat16(v); }
};
struct EmbedEpi {  // h[m][n] = v + pe[m][n] (embedding + positional table)
  float* h;
  const bf16* pe;
  int E;
  __device__ void operator()(int m, int n, float v) const { h[m * E + n] = v + tof(pe[m * E + n]); }
};
struct AddTo {  // residual: out[m][n] += v
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] += v; }
};

}  // namespace sd
