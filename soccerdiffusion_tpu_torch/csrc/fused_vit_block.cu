// Fused pre-norm ViT block, forward: one thread block per frame.
//
// Replaces soccerdiffusion_tpu/ops/fused_vit_block.py: make_vit_block_fn's
// forward (_fwd_impl; _make_fwd_kernel over _block_core, or the
// "headloop" layout's kernel, which computes the same function). The
// backward kernel (_bwd_impl) comes with the training slice.
//
// Per frame of T tokens and width W, with H heads of D = W / H and an MLP of
// width FF:
//   x2 = x + attn(LN1(x)) @ wo + bo;  y = x2 + gelu(LN2(x2) @ w1 + b1) @ w2 + b2
// at the TPU kernel's rounding points: bf16 input and output, fp32
// LayerNorm (eps 1e-6), q|k|v rounded to bf16 after the bias, fp32 scores
// x 1/sqrt(D) and softmax with the probabilities rounded to bf16 before the
// value sum, the head outputs rounded to bf16, the out-projection added to
// the fp32 residual, z = LN2(x2) @ w1 + b1 in fp32 and hg = z * cdf(z)
// rounded to bf16, where cdf is the exact normal CDF (erff) or quick-GELU's
// sigmoid(1.702 z); the output rounded once.
//
// Bound on the H100: 2 T (3 W^2 + W^2 + 2 W FF) + 4 T^2 W FLOP per frame =
// 105 MFLOP at T=64, W=256, FF=1024 (13.4 GFLOP per launch at N=128
// frames), against 2 x 32 KB of frame bytes and 1.5 MB of weights that stay
// L2-resident: compute-bound, 13.6 us at the 989 TFLOP/s bf16 tensor-core
// peak. This first kernel does its products as scalar fp32 FMAs (dense()
// of common.cuh), as the other kernels of this directory do: 0.97-0.99 ms per
// N=128 launch on an H100 80GB HBM3 at 700 W, ~14 TFLOP/s (PERF.md);
// tensor-core products are later work.
//
// Design: the whole frame lives in shared memory -- the fp32 residual
// (T, W), the bf16 LayerNorm / attention output (T, W), bf16 q|k|v (T,
// 3W + 8) and one head's fp32 probability tile (T, T): 209 KB at the
// flagship shape. The MLP hidden of a frame (T x FF bf16, 128 KB) does not
// fit beside them, so the MLP runs over tiles of `mlp_rows` token rows whose
// hidden reuses the q|k|v region. The q|k|v rows are padded by 8 elements
// so that lanes reading different key rows hit different banks. Not
// carried over from the TPU kernel: the lane-masked head stacking
// (_masks/_mask4) and the (F, HT, T) score layout (one head at a time
// instead), the frame-block grid (one block per frame), the polynomial erf.
#include "train_common.cuh"

namespace sd {

constexpr int kVitThreads = 512;

struct VitArgs {
  const bf16* x;  // (N, T, W)
  // g1 be1 wqkv (W, 3W) bqkv wo (W, W) bo g2 be2 w1 (W, FF) b1 w2 (FF, W) b2
  const bf16* w[12];
  bf16* y;  // (N, T, W)
  int N, T, W, H, FF, mlp_rows;
};

template <bool kQuick>
struct GeluBf16 {  // bf16 out[m][n] = z * cdf(z) of the fp32 sum z
  bf16* out;
  int ld;
  __device__ void operator()(int m, int n, float z) const {
    const float cdf = kQuick ? 1.f / (1.f + expf(-1.702f * z)) : gelu_cdf(z);
    out[m * ld + n] = __float2bfloat16(z * cdf);
  }
};

__host__ __device__ inline int vit_qkv_ld(int W) { return 3 * W + 8; }

// shared-memory bytes of one frame (the layout of vit_block_fwd_kernel)
__host__ __device__ inline size_t vit_smem_bytes(int T, int W) {
  const size_t f32 = (size_t)T * W + r4((size_t)T * T);                // h, P
  const size_t b16 = (size_t)T * W + (size_t)T * (size_t)vit_qkv_ld(W);  // act, q|k|v
  return 4 * f32 + 2 * b16;
}

template <int D, bool kQuick>
__global__ void __launch_bounds__(kVitThreads) vit_block_fwd_kernel(VitArgs a) {
  extern __shared__ float4 smem4[];
  const int T = a.T, W = a.W, FF = a.FF, LDQ = vit_qkv_ld(W);
  const bf16 *g1 = a.w[0], *be1 = a.w[1], *wqkv = a.w[2], *bqkv = a.w[3], *wo = a.w[4],
             *bo = a.w[5], *g2 = a.w[6], *be2 = a.w[7], *w1 = a.w[8], *b1 = a.w[9],
             *w2 = a.w[10], *b2 = a.w[11];
  float* h = reinterpret_cast<float*>(smem4);           // (T, W) fp32 residual
  float* P = h + T * W;                                  // (T, T) one head's probabilities
  bf16* act = reinterpret_cast<bf16*>(P + r4(T * T));   // (T, W) LayerNorm / attention output
  bf16* qkv = act + T * W;                               // (T, LDQ) q|k|v, then the MLP hidden

  const bf16* x = a.x + (size_t)blockIdx.x * T * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) h[i] = tof(x[i]);
  __syncthreads();
  // attention sublayer
  layer_norm_rows(h, W, T, W, g1, be1, act, W);
  __syncthreads();
  dense<8, 2>(act, W, T, W, wqkv, 3 * W, bqkv, StoreRoundBf16{qkv, LDQ});
  __syncthreads();
  for (int hh = 0; hh < a.H; ++hh) {  // head hh's output into act[:, hh D : (hh + 1) D]
    const bf16* q = qkv + hh * D;
    head_probs<D>(q, LDQ, q + W, LDQ, T, T, P);
    head_out<D>(P, T, T, q + 2 * W, LDQ, act + hh * D, W);
  }
  dense<8, 2>(act, W, T, W, wo, W, bo, AddTo{h, W});
  __syncthreads();
  // MLP sublayer, mlp_rows token rows at a time
  layer_norm_rows(h, W, T, W, g2, be2, act, W);
  __syncthreads();
  for (int r0 = 0; r0 < T; r0 += a.mlp_rows) {
    const int rows = min(a.mlp_rows, T - r0);
    dense<8, 2>(act + r0 * W, W, rows, W, w1, FF, b1, GeluBf16<kQuick>{qkv, FF});
    __syncthreads();
    dense<8, 2>(qkv, FF, rows, FF, w2, W, b2, AddTo{h + r0 * W, W});
    __syncthreads();
  }
  bf16* y = a.y + (size_t)blockIdx.x * T * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) y[i] = __float2bfloat16(h[i]);
}

}  // namespace sd

// ptrs: x, 12 weights (VitArgs order), y
// ints: N, T, W, H, FF, quick (0: exact GELU, 1: quick-GELU)
extern "C" int sd_vit_block_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  VitArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[1 + i]);
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[13]));
  a.N = ints[0];
  a.T = ints[1];
  a.W = ints[2];
  a.H = ints[3];
  a.FF = ints[4];
  const bool quick = ints[5] != 0;
  const int D = head_dim(a.W, a.H);
  if (D == 0 || a.T < 1 || a.W % 8 || a.FF % 8) return (int)cudaErrorInvalidValue;
  const int fit = a.T * vit_qkv_ld(a.W) / a.FF;  // hidden rows that fit the q|k|v region
  a.mlp_rows = fit < a.T ? fit : a.T;
  if (a.mlp_rows < 1) return (int)cudaErrorInvalidValue;
  auto kernel = D == 32
                     ? (quick ? vit_block_fwd_kernel<32, true> : vit_block_fwd_kernel<32, false>)
                     : (quick ? vit_block_fwd_kernel<64, true> : vit_block_fwd_kernel<64, false>);
  // refused when a frame does not fit one block's shared memory
  const size_t smem = vit_smem_bytes(a.T, a.W);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.N, kVitThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
