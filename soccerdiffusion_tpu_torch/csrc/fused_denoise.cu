// Fused denoiser: one pass of the whole cross-attending decoder against
// pre-projected context K/V, one thread block per robot.
//
// Replaces soccerdiffusion_tpu/ops/fused_denoise.py: FusedDenoiser.__call__
// and FusedDenoiser._call_with_precomputed (_make_kernel). Both call sites
// share this kernel; `has_coefs` selects the in-kernel DDIM epilogue
// (x_prev instead of eps). Instances for head_dim 32 (h128) and 64 (h256).
//
// Bound on the H100: per robot and pass the kernel reads the robot's
// context K/V (L x 2 x S x E bf16 = 616 KB at L=4, S=301, E=128) from HBM
// once (B=1024 is 631 MB, a 0.19 ms floor at 3.35 TB/s) against ~17 MFLOP
// of work. Its scalar fp32 math bounds it instead: 2.2 ms at B=1024 on an
// H100 80GB HBM3 at 700 W, ~8 TFLOP/s (PERF.md); tensor-core products are
// the next step. Design: everything except the context
// K/V stays in shared memory (fp32 residual, q/k/v, the (H, P, S+1) score
// block); each K row is loaded once per head and scored against all P
// query rows, each V element once per 5 query rows, so the K/V bytes are
// read about once per pass. Weights (1 MB) stay L2-resident across blocks.
#include "decoder_layer.cuh"

namespace sd {

struct DenoiseArgs {
  DecoderWeights w;
  const float* noisy;  // (B, P, J) fp32
  const bf16* ctx_k;   // (L, B, S, E)
  const bf16* ctx_v;   // (L, B, S, E)
  const bf16* stk;     // (L, E) step-token cross K, shared by all robots
  const bf16* stv;     // (L, E)
  float* out;          // (B, P, J) fp32: eps, or x_prev with coefs
  float c0, c1, c2, c3;  // [1/sqrt(abar_t), sqrt(1-abar_t), sqrt(abar_prev), sqrt(1-abar_prev)]
  int B, S, has_coefs;
};

struct DenoiseEpi {
  float* out;
  const float* x;
  float c0, c1, c2, c3;
  int J, has_coefs;
  __device__ void operator()(int p, int j, float eps) const {
    const int i = p * J + j;
    if (has_coefs) {
      const float x0 = (x[i] - c1 * eps) * c0;
      out[i] = c2 * x0 + c3 * eps;
    } else {
      out[i] = eps;
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) fused_denoise_kernel(DenoiseArgs a) {
  extern __shared__ float4 smem4[];
  const DecoderWeights& w = a.w;
  const int b = blockIdx.x;
  const DecoderSmem sm = carve_decoder_smem(reinterpret_cast<float*>(smem4), w.P, w.E, w.H, w.J, a.S);
  const size_t PJ = (size_t)w.P * w.J, SE = (size_t)a.S * w.E;
  const float* x = a.noisy + b * PJ;
  decoder_pass<D>(w, sm, x, a.ctx_k + b * SE, a.ctx_v + b * SE, a.B * SE, a.stk, a.stv, a.S,
                  DenoiseEpi{a.out + b * PJ, x, a.c0, a.c1, a.c2, a.c3, w.J, a.has_coefs});
}

}  // namespace sd

// ptrs: 19 DecoderWeights pointers (declaration order), noisy, ctx_k, ctx_v,
//       stk, stv, out
// ints: L, E, H, P, J, B, S, has_coefs;  floats: c0..c3
extern "C" int sd_fused_denoise(const void* const* ptrs, const int* ints, const float* floats,
                                void* stream) {
  using namespace sd;
  DenoiseArgs a;
  const bf16* const* wp = reinterpret_cast<const bf16* const*>(ptrs);
  a.w = DecoderWeights{wp[0],  wp[1],  wp[2],  wp[3],  wp[4],  wp[5],  wp[6],
                       wp[7],  wp[8],  wp[9],  wp[10], wp[11], wp[12], wp[13],
                       wp[14], wp[15], wp[16], wp[17], wp[18], ints[0], ints[1],
                       ints[2], ints[3], ints[4]};
  a.noisy = static_cast<const float*>(ptrs[19]);
  a.ctx_k = static_cast<const bf16*>(ptrs[20]);
  a.ctx_v = static_cast<const bf16*>(ptrs[21]);
  a.stk = static_cast<const bf16*>(ptrs[22]);
  a.stv = static_cast<const bf16*>(ptrs[23]);
  a.out = static_cast<float*>(const_cast<void*>(ptrs[24]));
  a.B = ints[5];
  a.S = ints[6];
  a.has_coefs = ints[7];
  a.c0 = floats[0];
  a.c1 = floats[1];
  a.c2 = floats[2];
  a.c3 = floats[3];
  const int D = head_dim(a.w.E, a.w.H);
  if (D == 0) return (int)cudaErrorInvalidValue;
  auto kernel = D == 32 ? fused_denoise_kernel<32> : fused_denoise_kernel<64>;
  const size_t smem = decoder_smem_floats(a.w.P, a.w.E, a.w.H, a.w.J, a.S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
