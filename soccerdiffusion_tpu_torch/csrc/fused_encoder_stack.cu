// Fused L-layer encoder stack for training: forward (kernel C) and
// hand-written backward (kernel D), one thread block per robot.
//
// Replaces soccerdiffusion_tpu/ops/fused_encoder_stack.py:
// make_encoder_stack_fn (_fwd_impl, _make_fwd_kernel / _stack_core; and
// _bwd_impl, _make_bwd_kernel).
//
// Bound on the H100: per robot and layer at T=100 tokens, E=FF=256
// (head_dim 64) the forward is ~89 MFLOP and the backward (recompute
// included) ~267 MFLOP: compute-bound at the 989 TFLOP/s bf16 tensor-core
// peak (0.046 ms forward at B=256, L=2; PERF.md). The first port did every
// product as scalar fp32 FMAs (~14 TFLOP/s); every product is now an
// mma.sync tensor-core product (encoder_layer.cuh, mma.cuh). What bounds the
// forward now: one robot per block at 16 warps (203 KB of shared memory at
// T=100, E=256), B fragments read from L2 with 32-bit loads, the fp32
// residual kept in global memory, the scalar LayerNorm passes. What bounds
// the backward: the per-robot workspace traffic (written and read back
// through L2 between the products), the scalar LayerNorm and column-sum row
// passes and one block per robot (B=64 fills 64 of 132 SMs). Design:
//   * the TPU kernel keeps a 16-robot block and all intermediates in 110 MB
//     of VMEM. Here the forward keeps a robot's bf16 operands (LayerNorm /
//     attention output, q|k|v, one MLP chunk) in shared memory and its fp32
//     residual in `acts` (encoder_layer.cuh:layer_fwd_smem, which the ViT
//     block's forward shares); the backward keeps every intermediate of a
//     robot's layer in a per-robot global workspace (L1/L2-resident while
//     the block runs) and 3 floats of softmax statistics per (head, row) in
//     shared memory; the attention scores stay in registers throughout;
//   * the forward writes each layer's fp32 input to `acts`, so the
//     backward recomputes one layer's internals at a time from its input
//     (the TPU kernel recomputes the L+1 inter-layer activations);
//   * the weight gradients are not accumulated across blocks (the TPU
//     kernel's `+=` over a sequential grid would race here): the backward
//     writes the bf16 operands of every `tdot` product and per-robot fp32
//     partials of every bias / LayerNorm gradient, and weight_grads.cu sums
//     both over the batch in a fixed order;
//   * no 8-row padding or key masks (T rows as they are, masked at the mma
//     tile edges), no lane-masked head stacking, erff for the exact GELU;
//   * forward and backward have instances for head_dim 32 and 64 (the h256
//     configs' 4-head proprioceptive stacks; their 8-head image-sequence
//     stack is head_dim 32);
//   * the products of the forward and of the recompute read the weights
//     transposed, (out, in) (wt, made by the wrapper), the input-gradient
//     products the (in, out) originals: the reduction axis is contiguous.
#include "encoder_layer.cuh"

namespace sd {

struct EncStackArgs {
  const bf16* x;      // fwd: (B, T, E) input
  const float* acts;  // bwd: (L, B, T, E) fp32 input of every layer
  float* acts_out;    // fwd: the same, written
  const bf16* dy;     // bwd: (B, T, E)
  bf16* out;          // fwd: y; bwd: dx (B, T, E)
  // stacked (L, ...) bf16 weights: g1 be1 wqkv bqkv wo bo g2 be2 w1 b1 w2 b2
  const bf16* w[12];
  // transposed wqkv (L, 3E, E), wo (L, E, E), w1 (L, FF, E), w2 (L, E, FF)
  const bf16* wt[4];
  float* ws32;      // (B, ws32_stride) per-robot fp32 workspace (fwd: the last layer's output)
  bf16* wsbf;       // (B, wsbf_stride) per-robot bf16 workspace
  bf16* saved;      // (L, B*T, 8E + 2FF) rows: n1 dqkv om da n2 dzc hg gc
  float* vpart;     // bwd: (B, L, 9E + FF) per-robot bias / LN gradient partials
  int B, T, E, H, FF, L, ws32_stride, wsbf_stride;
};

__device__ inline EncLayer layer_weights(const EncStackArgs& a, int l) {
  const size_t E = a.E, FF = a.FF;
  EncLayer w;
  w.g1 = a.w[0] + l * E;
  w.be1 = a.w[1] + l * E;
  w.wqkv = a.w[2] + l * E * 3 * E;
  w.bqkv = a.w[3] + l * 3 * E;
  w.wo = a.w[4] + l * E * E;
  w.bo = a.w[5] + l * E;
  w.g2 = a.w[6] + l * E;
  w.be2 = a.w[7] + l * E;
  w.w1 = a.w[8] + l * E * FF;
  w.b1 = a.w[9] + l * FF;
  w.w2 = a.w[10] + l * FF * E;
  w.b2 = a.w[11] + l * E;
  w.wqkv_t = a.wt[0] + l * 3 * E * E;
  w.wo_t = a.wt[1] + l * E * E;
  w.w1_t = a.wt[2] + l * FF * E;
  w.w2_t = a.wt[3] + l * E * FF;
  return w;
}

__device__ inline EncWs robot_ws(const EncStackArgs& a, int b) {
  EncWs s;
  size_t n32, nbf;
  carve(a.T, a.E, a.FF, a.ws32 + (size_t)b * a.ws32_stride, a.wsbf + (size_t)b * a.wsbf_stride,
        &s, &n32, &nbf);
  return s;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads) encoder_stack_fwd_kernel(EncStackArgs a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x, T = a.T, E = a.E;
  bf16* act = reinterpret_cast<bf16*>(smem4);  // (T, E + 8)
  bf16* qkv = act + T * (E + 8);               // (T, 3E + 8)
  const size_t te = (size_t)T * E;
  const bf16* x = a.x + b * te;
  float* x0 = a.acts_out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) x0[i] = tof(x[i]);
  __syncthreads();
  float* last = a.ws32 + (size_t)b * a.ws32_stride;  // the last layer's fp32 output
  for (int l = 0; l < a.L; ++l) {
    const float* in = a.acts_out + ((size_t)l * a.B + b) * te;
    float* out = l + 1 < a.L ? a.acts_out + ((size_t)(l + 1) * a.B + b) * te : last;
    layer_fwd_smem<D, false>(layer_weights(a, l), in, out, act, qkv, T, E, a.FF, a.H);
  }
  bf16* y = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) y[i] = __float2bfloat16(last[i]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) encoder_stack_bwd_kernel(EncStackArgs a) {
  extern __shared__ float4 smem4[];
  float* stats = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, T = a.T, E = a.E, WS = 8 * a.E + 2 * a.FF, V = 9 * a.E + a.FF;
  const EncWs s = robot_ws(a, b);
  const size_t te = (size_t)T * E;
  const bf16* dy = a.dy + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) s.g[i] = tof(dy[i]);
  __syncthreads();
  for (int l = a.L - 1; l >= 0; --l) {
    const EncLayer w = layer_weights(a, l);
    bf16* sv = a.saved + ((size_t)l * a.B + b) * T * WS;
    // recompute the layer's internals (its output is not needed: into tmp)
    layer_fwd<D, false>(w, s, sv, WS, a.acts + ((size_t)l * a.B + b) * te, s.tmp, T, E, a.FF,
                        a.H);
    layer_bwd<D, false>(w, s, sv, WS, stats, a.vpart + ((size_t)b * a.L + l) * V, T, E, a.FF, a.H);
  }
  bf16* dx = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
}

// The backward's argument checks (head_dim 32 or 64, widths multiples of 8,
// the workspace strides); returns its shared memory (softmax stats).
static int setup(EncStackArgs& a, const int* ints, size_t* smem) {
  a.B = ints[0];
  a.T = ints[1];
  a.E = ints[2];
  a.H = ints[3];
  a.FF = ints[4];
  a.L = ints[5];
  a.ws32_stride = ints[6];
  a.wsbf_stride = ints[7];
  size_t n32, nbf;
  carve(a.T, a.E, a.FF, nullptr, nullptr, nullptr, &n32, &nbf);
  if (head_dim(a.E, a.H) == 0 || a.E % 8 || a.FF % 8 || n32 > (size_t)a.ws32_stride ||
      nbf > (size_t)a.wsbf_stride)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)3 * a.H * a.T * sizeof(float);
  return 0;
}

}  // namespace sd

// ptrs: x, 12 stacked weights, y, acts (L, B, T, E) fp32, ws32 (B, ws32_stride >= T E),
//       wsbf, saved (unused by the forward), 4 transposed (wqkv, wo, w1, w2)
// ints: B, T, E, H, FF, L, ws32_stride, wsbf_stride
extern "C" int sd_encoder_stack_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  EncStackArgs a = {};
  a.B = ints[0];
  a.T = ints[1];
  a.E = ints[2];
  a.H = ints[3];
  a.FF = ints[4];
  a.L = ints[5];
  a.ws32_stride = ints[6];
  if (head_dim(a.E, a.H) == 0 || a.T < 1 || a.E % 8 || a.FF % 8 ||
      (size_t)a.T * a.E > (size_t)a.ws32_stride)
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(ptrs[0]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[1 + i]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[13]));
  a.acts_out = static_cast<float*>(const_cast<void*>(ptrs[14]));
  a.ws32 = static_cast<float*>(const_cast<void*>(ptrs[15]));
  for (int i = 0; i < 4; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[18 + i]);
  auto kernel =
      head_dim(a.E, a.H) == 32 ? encoder_stack_fwd_kernel<32> : encoder_stack_fwd_kernel<64>;
  // refused when a robot's operands do not fit one block's shared memory
  const size_t smem = fwd_smem_bytes(a.T, a.E);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: acts, dy, 12 stacked weights, 4 transposed (wqkv, wo, w1, w2), dx,
//       dwqkv (L,E,3E), dwo (L,E,E), dw1 (L,E,FF), dw2 (L,FF,E), gvec (L, 9E+FF),
//       ws32, wsbf, saved (L, B*T, 8E+2FF), vpart (B, L, 9E+FF), tpart
// ints: B, T, E, H, FF, L, ws32_stride, wsbf_stride, rows_per_split
extern "C" int sd_encoder_stack_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  EncStackArgs a = {};
  size_t smem;
  if (int err = setup(a, ints, &smem)) return err;
  const int rows_per_split = ints[8];
  auto P = [&](int i) { return const_cast<void*>(ptrs[i]); };
  a.acts = static_cast<const float*>(ptrs[0]);
  a.dy = static_cast<const bf16*>(ptrs[1]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[2 + i]);
  for (int i = 0; i < 4; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[14 + i]);
  a.out = static_cast<bf16*>(P(18));
  float* mats[4] = {static_cast<float*>(P(19)), static_cast<float*>(P(20)),
                    static_cast<float*>(P(21)), static_cast<float*>(P(22))};
  float* gvec = static_cast<float*>(P(23));
  a.ws32 = static_cast<float*>(P(24));
  a.wsbf = static_cast<bf16*>(P(25));
  a.saved = static_cast<bf16*>(P(26));
  a.vpart = static_cast<float*>(P(27));
  float* tpart = static_cast<float*>(P(28));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel =
      head_dim(a.E, a.H) == 32 ? encoder_stack_bwd_kernel<32> : encoder_stack_bwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // weight gradients: per layer (n1, dqkv) (om, da) (n2, dzc) (hg, gc)
  const int E = a.E, FF = a.FF, R = a.B * a.T;
  TdotJob jobs[32];
  if (4 * a.L > 32) return (int)cudaErrorInvalidValue;
  size_t off = 0;
  for (int l = 0; l < a.L; ++l) {
    float* lm[4] = {mats[0] + (size_t)l * E * 3 * E, mats[1] + (size_t)l * E * E,
                    mats[2] + (size_t)l * E * FF, mats[3] + (size_t)l * FF * E};
    off += layer_tdot_jobs(a.saved + (size_t)l * R * (8 * E + 2 * FF), R, E, FF, lm, tpart + off,
                           rows_per_split, jobs + 4 * l);
  }
  const SumJob vec{a.vpart, gvec, a.B, a.L * (9 * E + FF)};
  // launch_weight_grads takes at most 16 products per call
  for (int base = 0; base < 4 * a.L; base += 16) {
    const int n = 4 * a.L - base < 16 ? 4 * a.L - base : 16;
    const bool last = base + n == 4 * a.L;
    if (int e = launch_weight_grads(jobs + base, n, &vec, last ? 1 : 0, rows_per_split, st)) return e;
  }
  return 0;
}
