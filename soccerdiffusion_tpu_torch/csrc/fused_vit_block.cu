// Fused pre-norm ViT block, forward and backward: one thread block per frame.
//
// Replaces soccerdiffusion_tpu/ops/fused_vit_block.py: make_vit_block_fn's
// forward (_fwd_impl; _make_fwd_kernel over _block_core, or the
// "headloop" layout's kernel, which computes the same function) and its
// backward (_bwd_impl; _make_bwd_kernel / _make_headloop_bwd_kernel).
//
// FORWARD (vit_block_fwd_kernel)
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
#include "encoder_layer.cuh"

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
    out[m * ld + n] = __float2bfloat16(z * gelu_gate<kQuick>(z));
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

// BACKWARD (vit_block_bwd_kernel)
//
// The block is one pre-norm encoder layer, so the backward is the encoder
// stack's layer (encoder_layer.cuh) at L = 1 with the block's GELU: one
// thread block per frame recomputes the frame's forward internals from x
// (the only residual, as in the JAX custom_vjp) and runs the hand-derived
// backward at the TPU kernel's rounding points -- dhg and the GELU gradient
// (erff, or quick-GELU's s (1 + 1.702 z (1 - s))) in fp32, dzc, dq / dk /
// dv and dom rounded to bf16, fp32 LayerNorm backwards, dx rounded once.
// Its intermediates (the (T, FF) MLP hidden does not fit shared memory
// beside the rest: 256 KB fp32 at the flagship shape) live in a per-frame
// global workspace that stays L2-resident while the block runs; one head's
// (T x T) fp32 probabilities sit in shared memory. It writes dx, the bf16
// operands of the four weight-gradient products per row, (n1, dqkv) (om,
// da) (n2, dzc) (hg, gc), and per-frame fp32 partials of the eight vector
// gradients; weight_grads.cu then sums both over the N T rows and N frames
// in a fixed order (no atomics: the TPU kernel's `+=` into the weight
// gradients across its sequential grid would race across thread blocks).
//
// Bound on the H100: the recompute, the input gradients and the four
// weight-gradient products are ~3x the forward's FLOPs, ~315 MFLOP per frame
// at T=64, W=256, FF=1024 (202 GFLOP at N=640 frames): compute-bound at the
// bf16 tensor-core peak (0.2 ms). Done here, like the forward, as scalar
// fp32 FMAs; tensor-core products are later work (PERF.md).
struct VitBwdArgs {
  const bf16* x;   // (N, T, W)
  const bf16* dy;  // (N, T, W)
  const bf16* w[12];
  const bf16* wt[4];  // transposed wqkv (3W, W), wo (W, W), w1 (FF, W), w2 (W, FF)
  bf16* dx;           // (N, T, W)
  float* ws32;        // (N, ws32_stride) per-frame fp32 workspace
  bf16* wsbf;         // (N, wsbf_stride) per-frame bf16 workspace
  bf16* saved;        // (N T, 8W + 2FF) weight-gradient operand rows
  float* vpart;       // (N, 9W + FF) per-frame vector-gradient partials
  int N, T, W, H, FF, ws32_stride, wsbf_stride;
};

template <int D, bool kQuick>
__global__ void __launch_bounds__(kThreads) vit_block_bwd_kernel(VitBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  const int f = blockIdx.x, T = a.T, W = a.W, FF = a.FF, WS = 8 * W + 2 * FF;
  EncWs s;
  size_t n32, nbf;
  carve(T, W, FF, a.ws32 + (size_t)f * a.ws32_stride, a.wsbf + (size_t)f * a.wsbf_stride, &s,
        &n32, &nbf);
  const size_t tw = (size_t)T * W;
  const bf16 *x = a.x + f * tw, *dy = a.dy + f * tw;
  // the frame's fp32 input goes to dx2, which the backward writes only after
  // its last read; dL/dy to g
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) {
    s.dx2[i] = tof(x[i]);
    s.g[i] = tof(dy[i]);
  }
  __syncthreads();
  const EncLayer w{a.w[0], a.w[1], a.w[2],  a.w[3],  a.w[4],  a.w[5],  a.w[6],  a.w[7],
                   a.w[8], a.w[9], a.w[10], a.w[11], a.wt[0], a.wt[1], a.wt[2], a.wt[3]};
  bf16* sv = a.saved + (size_t)f * T * WS;
  layer_fwd<D, kQuick>(w, s, sv, WS, s.dx2, s.tmp, P, T, W, FF, a.H);
  layer_bwd<D, kQuick>(w, s, sv, WS, P, a.vpart + (size_t)f * (9 * W + FF), T, W, FF, a.H);
  bf16* dx = a.dx + f * tw;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
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

// ptrs: x, dy, 12 weights, 4 transposed (wqkv, wo, w1, w2), dx,
//       dwqkv (W,3W), dwo (W,W), dw1 (W,FF), dw2 (FF,W), gvec (9W+FF),
//       ws32, wsbf, saved (N*T, 8W+2FF), vpart (N, 9W+FF), tpart
// ints: N, T, W, H, FF, quick, ws32_stride, wsbf_stride, rows_per_split
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
  const bool quick = ints[5] != 0;
  a.ws32_stride = ints[6];
  a.wsbf_stride = ints[7];
  const int rows_per_split = ints[8];
  const int D = head_dim(a.W, a.H);
  size_t n32, nbf;
  carve(a.T, a.W, a.FF, nullptr, nullptr, nullptr, &n32, &nbf);
  if (D == 0 || a.T < 1 || a.W % 8 || a.FF % 8 || n32 > (size_t)a.ws32_stride ||
      nbf > (size_t)a.wsbf_stride)
    return (int)cudaErrorInvalidValue;
  auto kernel = D == 32
                    ? (quick ? vit_block_bwd_kernel<32, true> : vit_block_bwd_kernel<32, false>)
                    : (quick ? vit_block_bwd_kernel<64, true> : vit_block_bwd_kernel<64, false>);
  const size_t smem = (size_t)a.T * a.T * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.N, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // weight gradients: (n1, dqkv) (om, da) (n2, dzc) (hg, gc) over the N T rows
  TdotJob jobs[4];
  layer_tdot_jobs(a.saved, a.N * a.T, a.W, a.FF, mats, tpart, rows_per_split, jobs);
  const SumJob vec{a.vpart, gvec, a.N, 9 * a.W + a.FF};
  return launch_weight_grads(jobs, 4, &vec, 1, rows_per_split, st);
}
