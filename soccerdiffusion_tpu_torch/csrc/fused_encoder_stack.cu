// Fused L-layer encoder stack for training: forward (kernel C) and
// hand-written backward (kernel D), one thread block per robot.
//
// Replaces soccerdiffusion_tpu/ops/fused_encoder_stack.py:
// make_encoder_stack_fn (_fwd_impl, _make_fwd_kernel / _stack_core; and
// _bwd_impl, _make_bwd_kernel).
//
// Bound on the H100: per robot and layer at T=100 tokens, E=FF=128 the
// forward is ~25 MFLOP and the backward (recompute included) ~75 MFLOP of
// scalar fp32 FMAs against a per-robot workspace of ~0.6 MB -- compute-
// and latency-bound, like the serving encoder (PERF.md). Design:
//   * the TPU kernel keeps a 16-robot block and all intermediates in 110 MB
//     of VMEM; here every intermediate of a robot's layer lives in a
//     per-robot global workspace (L1/L2-resident while the block runs) and
//     only one head's (T x T) fp32 probability tile is in shared memory;
//   * the forward writes each layer's fp32 input to `acts`, so the
//     backward recomputes one layer's internals at a time from its input
//     (the TPU kernel recomputes the L+1 inter-layer activations);
//   * the weight gradients are not accumulated across blocks (the TPU
//     kernel's `+=` over a sequential grid would race here): the backward
//     writes the bf16 operands of every `tdot` product and per-robot fp32
//     partials of every bias / LayerNorm gradient, and weight_grads.cu sums
//     both over the batch in a fixed order;
//   * no 8-row padding or key masks (T rows as they are), no lane-masked
//     head stacking (one head at a time), erff for the exact GELU;
//   * the forward has instances for head_dim 32 and 64 (the h256 configs'
//     4-head proprioceptive stacks; their 8-head image-sequence stack is
//     head_dim 32); the backward takes head_dim 32.
#include "train_common.cuh"

namespace sd {

struct EncStackArgs {
  const bf16* x;      // fwd: (B, T, E) input
  const float* acts;  // bwd: (L, B, T, E) fp32 input of every layer
  float* acts_out;    // fwd: the same, written
  const bf16* dy;     // bwd: (B, T, E)
  bf16* out;          // fwd: y; bwd: dx (B, T, E)
  // stacked (L, ...) bf16 weights: g1 be1 wqkv bqkv wo bo g2 be2 w1 b1 w2 b2
  const bf16* w[12];
  // bwd: transposed wqkv (L, 3E, E), wo (L, E, E), w1 (L, FF, E), w2 (L, E, FF)
  const bf16* wt[4];
  float* ws32;      // (B, ws32_stride) per-robot fp32 workspace
  bf16* wsbf;       // (B, wsbf_stride) per-robot bf16 workspace
  bf16* saved;      // (L, B*T, 8E + 2FF) rows: n1 dqkv om da n2 dzc hg gc
  float* vpart;     // bwd: (B, L, 9E + FF) per-robot bias / LN gradient partials
  int B, T, E, H, FF, L, ws32_stride, wsbf_stride;
};

struct EncWs {  // one robot's workspace
  float *g, *x2, *xh1, *xh2, *tmp, *dx2, *z, *dz, *r1, *r2;
  bf16 *qkv, *dom;
};

// Carves one robot's workspace (when f / h are given) and returns the fp32
// and bf16 elements it needs (ops/fused_encoder_stack.py:_ws_strides).
__host__ __device__ inline void carve(int T, int E, int FF, float* f, bf16* h, EncWs* w,
                                      size_t* n32, size_t* nbf) {
  const size_t te = r4((size_t)T * E), tf = r4((size_t)T * FF), t = r4(T);
  *n32 = 6 * te + 2 * tf + 2 * t;
  *nbf = r8((size_t)3 * T * E) + r8((size_t)T * E);
  if (w == nullptr) return;
  w->g = f;
  w->x2 = f + te;
  w->xh1 = f + 2 * te;
  w->xh2 = f + 3 * te;
  w->tmp = f + 4 * te;
  w->dx2 = f + 5 * te;
  w->z = f + 6 * te;
  w->dz = f + 6 * te + tf;
  w->r1 = f + 6 * te + 2 * tf;
  w->r2 = f + 6 * te + 2 * tf + t;
  w->qkv = h;
  w->dom = h + r8((size_t)3 * T * E);
}

struct EncLayer {
  const bf16 *g1, *be1, *wqkv, *bqkv, *wo, *bo, *g2, *be2, *w1, *b1, *w2, *b2;
  const bf16 *wqkv_t, *wo_t, *w1_t, *w2_t;
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
  w.wqkv_t = a.wt[0] == nullptr ? nullptr : a.wt[0] + l * 3 * E * E;
  w.wo_t = a.wt[1] == nullptr ? nullptr : a.wt[1] + l * E * E;
  w.w1_t = a.wt[2] == nullptr ? nullptr : a.wt[2] + l * FF * E;
  w.w2_t = a.wt[3] == nullptr ? nullptr : a.wt[3] + l * E * FF;
  return w;
}

// One layer's forward for one robot: x (T, E) fp32 -> y (T, E) fp32,
// leaving n1 / om / n2 / hg in the saved row `sv` (stride WS) and q|k|v,
// xhat, rstd, x2, z in the workspace for the backward. D is the head dim.
template <int D>
__device__ void layer_fwd(const EncLayer& w, const EncWs& s, bf16* sv, int WS, const float* x,
                          float* y, float* P, int T, int E, int FF, int H) {
  bf16 *n1 = sv, *om = sv + 4 * E, *n2 = sv + 6 * E, *hg = sv + 7 * E + FF;
  ln_rows(x, T, E, w.g1, w.be1, n1, WS, s.xh1, s.r1);
  dense<8, 2>(n1, WS, T, E, w.wqkv, 3 * E, w.bqkv, StoreRoundBf16{s.qkv, 3 * E});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const bf16* q = s.qkv + h * D;
    head_probs<D>(q, 3 * E, q + E, 3 * E, T, T, P);
    head_out<D>(P, T, T, q + 2 * E, 3 * E, om + h * D, WS);
  }
  dense<8, 2>(om, WS, T, E, w.wo, E, w.bo, AddStore{x, s.x2, E});
  __syncthreads();
  ln_rows(s.x2, T, E, w.g2, w.be2, n2, WS, s.xh2, s.r2);
  dense<8, 2>(n2, WS, T, E, w.w1, FF, w.b1, GeluStore{s.z, FF, hg, WS});
  __syncthreads();
  dense<8, 2>(hg, WS, T, FF, w.w2, E, w.b2, AddStore{s.x2, y, E});
  __syncthreads();
}

// One layer's backward for one robot after layer_fwd: s.g holds dL/dy on
// entry and dL/dx on exit. Writes the bf16 operands of the weight-gradient
// products into the saved row and this robot's bias / LN partials to vp
// (g1 0, be1 E, bqkv 2E, bo 5E, g2 6E, be2 7E, b1 8E, b2 8E + FF).
__device__ void layer_bwd(const EncLayer& w, const EncWs& s, bf16* sv, int WS, float* P,
                          float* vp, int T, int E, int FF, int H) {
  bf16 *dqkv = sv + E, *da = sv + 5 * E, *dzc = sv + 7 * E, *gc = sv + 7 * E + 2 * FF;
  // MLP: dhg = g w2^T; dz = dhg GELU'(z); dn2 = dz w1^T
  to_bf16(s.g, E, T, E, gc, WS);
  colsum(s.g, E, T, E, nullptr, 0, vp + 8 * E + FF);
  __syncthreads();
  dense<8, 2>(gc, WS, T, E, w.w2_t, FF, nullptr, GeluBwd{s.z, s.dz, FF, dzc, WS});
  __syncthreads();
  colsum(s.dz, FF, T, FF, nullptr, 0, vp + 8 * E);
  dense<8, 2>(dzc, WS, T, FF, w.w1_t, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh2, E, vp + 6 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 7 * E);
  ln_bwd_rows(s.tmp, s.xh2, s.r2, w.g2, T, E, s.g, s.dx2);
  to_bf16(s.dx2, E, T, E, da, WS);
  colsum(s.dx2, E, T, E, nullptr, 0, vp + 5 * E);
  __syncthreads();
  // attention: dom = da wo^T, then one head at a time
  dense<8, 2>(da, WS, T, E, w.wo_t, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const int o = h * kHeadDim;
    const bf16* q = s.qkv + o;
    head_probs(q, 3 * E, q + E, 3 * E, T, T, P);
    head_bwd(P, T, T, q, 3 * E, q + E, 3 * E, q + 2 * E, 3 * E, s.dom + o, E, dqkv + o, WS,
             dqkv + E + o, WS, dqkv + 2 * E + o, WS, nullptr, nullptr, 0);
  }
  colsum(dqkv, WS, T, 3 * E, nullptr, 0, vp + 2 * E);
  dense<8, 2>(dqkv, WS, T, 3 * E, w.wqkv_t, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh1, E, vp);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + E);
  ln_bwd_rows(s.tmp, s.xh1, s.r1, w.g1, T, E, s.dx2, s.g);
}

__device__ inline EncWs robot_ws(const EncStackArgs& a, int b) {
  EncWs s;
  size_t n32, nbf;
  carve(a.T, a.E, a.FF, a.ws32 + (size_t)b * a.ws32_stride, a.wsbf + (size_t)b * a.wsbf_stride,
        &s, &n32, &nbf);
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads) encoder_stack_fwd_kernel(EncStackArgs a) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, T = a.T, E = a.E, WS = 8 * a.E + 2 * a.FF;
  const EncWs s = robot_ws(a, b);
  const size_t te = (size_t)T * E;
  const bf16* x = a.x + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) a.acts_out[b * te + i] = tof(x[i]);
  __syncthreads();
  bf16* sv = a.saved + (size_t)b * T * WS;
  for (int l = 0; l < a.L; ++l) {
    const float* in = a.acts_out + ((size_t)l * a.B + b) * te;
    float* out = l + 1 < a.L ? a.acts_out + ((size_t)(l + 1) * a.B + b) * te : s.g;
    layer_fwd<D>(layer_weights(a, l), s, sv, WS, in, out, P, T, E, a.FF, a.H);
  }
  bf16* y = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) y[i] = __float2bfloat16(s.g[i]);
}

__global__ void __launch_bounds__(kThreads) encoder_stack_bwd_kernel(EncStackArgs a) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
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
    layer_fwd<kHeadDim>(w, s, sv, WS, a.acts + ((size_t)l * a.B + b) * te, s.tmp, P, T, E, a.FF,
                        a.H);
    layer_bwd(w, s, sv, WS, P, a.vpart + ((size_t)b * a.L + l) * V, T, E, a.FF, a.H);
  }
  bf16* dx = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
}

// Common argument checks; returns the attention tile's shared memory.
// The head dimension is checked by each entry.
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
  *smem = (size_t)a.T * a.T * sizeof(float);
  return 0;
}

}  // namespace sd

// ptrs: x, 12 stacked weights, y, acts (L, B, T, E) fp32, ws32, wsbf, saved (B*T, 8E+2FF)
// ints: B, T, E, H, FF, L, ws32_stride, wsbf_stride
extern "C" int sd_encoder_stack_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  EncStackArgs a = {};
  size_t smem;
  if (int err = setup(a, ints, &smem)) return err;
  a.x = static_cast<const bf16*>(ptrs[0]);
  for (int i = 0; i < 12; ++i) a.w[i] = static_cast<const bf16*>(ptrs[1 + i]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[13]));
  a.acts_out = static_cast<float*>(const_cast<void*>(ptrs[14]));
  a.ws32 = static_cast<float*>(const_cast<void*>(ptrs[15]));
  a.wsbf = static_cast<bf16*>(const_cast<void*>(ptrs[16]));
  a.saved = static_cast<bf16*>(const_cast<void*>(ptrs[17]));
  auto kernel =
      head_dim(a.E, a.H) == 32 ? encoder_stack_fwd_kernel<32> : encoder_stack_fwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
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
  if (a.E != kHeadDim * a.H) return (int)cudaErrorInvalidValue;  // the backward: head_dim 32
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
  cudaError_t err = cudaFuncSetAttribute(encoder_stack_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  encoder_stack_bwd_kernel<<<a.B, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // weight gradients: per layer (n1, dqkv) (om, da) (n2, dzc) (hg, gc)
  const int E = a.E, FF = a.FF, WS = 8 * E + 2 * FF, R = a.B * a.T;
  const int cols[4][2] = {{0, E}, {4 * E, 5 * E}, {6 * E, 7 * E}, {7 * E + FF, 7 * E + 2 * FF}};
  const int KN[4][2] = {{E, 3 * E}, {E, E}, {E, FF}, {FF, E}};
  TdotJob jobs[32];
  if (4 * a.L > 32) return (int)cudaErrorInvalidValue;
  size_t off = 0;
  for (int l = 0; l < a.L; ++l) {
    const bf16* rows = a.saved + (size_t)l * R * WS;
    for (int j = 0; j < 4; ++j) {
      const int K = KN[j][0], N = KN[j][1];
      jobs[4 * l + j] = TdotJob{rows + cols[j][0], rows + cols[j][1], tpart + off,
                                mats[j] + (size_t)l * K * N, WS, WS, K, N, R};
      off += (size_t)tdot_splits(R, rows_per_split) * K * N;
    }
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
