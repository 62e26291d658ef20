// Device helpers of the training kernels (fused_encoder_stack.cu,
// fused_decoder_layer.cu) and the deterministic weight-gradient products
// (weight_grads.cu).
//
// The training kernels run one thread block per robot (or frame). Their
// forwards keep a robot's operands in shared memory; their backwards keep
// every intermediate of a robot's layer in a per-robot global workspace
// that the block writes and reads itself (L1/L2-resident while the block
// runs). Block-scope __syncthreads() orders those global writes and reads,
// so no pointer into a workspace is __restrict__ (a read-only load path
// would not see writes of the same launch).
//
// Rounding points are the TPU kernels' (soccerdiffusion_tpu/ops/
// fused_encoder_stack.py:_stack_core, fused_decoder_layer.py:_decoder_core
// and their _make_bwd_kernel): LayerNorm, softmax, the residual stream and
// every gradient that feeds a LayerNorm backward or a bias sum in fp32;
// LN outputs, q/k/v, attention outputs, the GELU output and every operand
// of a backward product rounded to bf16; probabilities rounded to bf16
// before a value sum. The GELU epilogues take the activation (exact, or for
// the ViT block one of the Gelu forms below); the products and the
// attention tiles are mma.cuh's.
#pragma once

#include "common.cuh"

namespace sd {

// element counts rounded up to 16-byte multiples (fp32 / bf16 workspace regions)
__host__ __device__ inline size_t r4(size_t n) { return (n + 3) & ~(size_t)3; }
__host__ __device__ inline size_t r8(size_t n) { return (n + 7) & ~(size_t)7; }

__device__ __forceinline__ float gelu_cdf(float z) {
  return 0.5f * (1.0f + erff(z * 0.7071067811865476f));
}

// The GELUs of the ViT block, in the order of ops/_train_math.py:GELUS
// (the wrappers pass the index): exact (erff), quick-GELU z sigmoid(1.702 z)
// in fp32, "poly" (the JAX package's minimax polynomial of exact GELU: on
// |z| <= 3.75, z / 2 + G(z^2) and its gradient 1 / 2 + z H(z^2) as Horner
// chains of FMAs on the clipped z; z (1) above, 0 below) and "bf16"
// (quick-GELU on z rounded to bf16 with every elementary op rounded to bf16,
// as XLA evaluates the JAX kernel's bf16 chain; its constant is bf16(1.702)
// = 1.703125; the gradient dz = bf16(bf16(dhg) s (1 + 1.702 z (1 - s))) in
// the same ops, whose fp32 column sum is the JAX kernel's db1).
enum Gelu { kGeluExact = 0, kGeluQuick = 1, kGeluPoly = 2, kGeluBf16 = 3 };

__device__ __forceinline__ float bround(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float gelu_poly_core(float z, bool grad) {
  const float kG[8] = {7.7387867635e-05f, 3.9815118597e-01f, -6.5148636098e-02f,
                       9.0873994758e-03f, -8.8830326732e-04f, 5.6548416021e-05f,
                       -2.0787433172e-06f, 3.3143120958e-08f};
  const float kH[7] = {7.9546119838e-01f, -2.5856087522e-01f, 5.3150608964e-02f,
                       -6.7156793228e-03f, 5.1222947652e-04f, -2.1502364740e-05f,
                       3.7926810910e-07f};
  const float zc = fminf(fmaxf(z, -3.75f), 3.75f), u = zc * zc;
  float acc;
  if (grad) {
    acc = kH[6];
#pragma unroll
    for (int k = 5; k >= 0; --k) acc = fmaf(acc, u, kH[k]);
    return z > 3.75f ? 1.f : z < -3.75f ? 0.f : fmaf(zc, acc, 0.5f);
  }
  acc = kG[7];
#pragma unroll
  for (int k = 6; k >= 0; --k) acc = fmaf(acc, u, kG[k]);
  return z > 3.75f ? z : z < -3.75f ? 0.f : fmaf(0.5f, zc, acc);
}

constexpr float kQuickBf16 = 1.703125f;  // bf16(1.702)

__device__ __forceinline__ float quick_gate_bf16(float zb) {  // zb: a bf16 value
  return bround(1.f / bround(1.f + bround(expf(bround(-kQuickBf16 * zb)))));
}
__device__ __forceinline__ float quick_slope_bf16(float zb, float s) {
  return bround(s * bround(1.f + bround(bround(kQuickBf16 * zb) * bround(1.f - s))));
}

// GELU(z) of the fp32 sum z, before its rounding to bf16
template <int G>
__device__ __forceinline__ float gelu_value(float z) {
  if constexpr (G == kGeluPoly) {
    return gelu_poly_core(z, false);
  } else if constexpr (G == kGeluBf16) {
    const float zb = bround(z);
    return zb * quick_gate_bf16(zb);
  } else if constexpr (G == kGeluQuick) {
    return z * (1.f / (1.f + expf(-1.702f * z)));
  } else {
    return z * gelu_cdf(z);
  }
}

// dL/dz of dhg = dL/dGELU(z)
template <int G>
__device__ __forceinline__ float gelu_dz(float dhg, float z) {
  if constexpr (G == kGeluPoly) {
    return dhg * gelu_poly_core(z, true);
  } else if constexpr (G == kGeluBf16) {
    const float zb = bround(z), s = quick_gate_bf16(zb);
    return bround(bround(dhg) * quick_slope_bf16(zb, s));
  } else if constexpr (G == kGeluQuick) {
    const float s = 1.f / (1.f + expf(-1.702f * z));
    return dhg * (s * (1.f + 1.702f * z * (1.f - s)));
  } else {
    const float cdf = gelu_cdf(z);
    return dhg * (cdf + z * (expf(-0.5f * z * z) * 0.3989422804014327f));
  }
}

// ---------------------------------------------------------------- epilogues
struct StoreF32 {  // out[m][n] = v
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = v; }
};
struct AddStore {  // out[m][n] = base[m][n] + v (a residual add into a new buffer)
  const float* base;
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = base[m * ld + n] + v; }
};
struct AddRoundBf16 {  // bf16 out[m][n] = base[m][n] + v
  const float* base;
  int ldb;
  bf16* out;
  int ldo;
  __device__ void operator()(int m, int n, float v) const {
    out[m * ldo + n] = __float2bfloat16(base[m * ldb + n] + v);
  }
};
template <int G = kGeluExact>
struct GeluStore {  // z = v (fp32), bf16 hg = GELU(z)
  float* z;
  int ldz;
  bf16* hg;
  int ldh;
  __device__ void operator()(int m, int n, float v) const {
    z[m * ldz + n] = v;
    hg[m * ldh + n] = __float2bfloat16(gelu_value<G>(v));
  }
};
template <int G = kGeluExact>
struct GeluBwd {  // dz = v * GELU'(z) (fp32; bf16-valued for kGeluBf16) and its bf16 copy
  const float* z;
  float* dz;
  int ld;
  bf16* dzc;
  int ldc;
  __device__ void operator()(int m, int n, float v) const {
    const float zz = z[m * ld + n];
    const float d = gelu_dz<G>(v, zz);
    dz[m * ld + n] = d;
    dzc[m * ldc + n] = __float2bfloat16(d);
  }
};

// ------------------------------------------------------------- row passes
// bf16 out = LayerNorm(x) * g + b with fp32 statistics; also keeps
// xhat = (x - mean) * rstd (M, E) and rstd (M) for the backward.
// One warp per row. x has row stride E.
__device__ inline void ln_rows(const float* x, int M, int E, const bf16* __restrict__ g,
                               const bf16* __restrict__ b, bf16* out, int ldo, float* xhat,
                               float* rstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int m = warp; m < M; m += nwarps) {
    const float* xr = x + m * E;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += xr[e];
    const float mean = warp_sum(s) / E;
    float v = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = xr[e] - mean;
      v += d * d;
    }
    const float r = rsqrtf(warp_sum(v) / E + kLnEps);
    for (int e = lane; e < E; e += 32) {
      const float xh = (xr[e] - mean) * r;
      xhat[m * E + e] = xh;
      out[m * ldo + e] = __float2bfloat16(xh * tof(g[e]) + tof(b[e]));
    }
    if (lane == 0) rstd[m] = r;
  }
  __syncthreads();
}

// out = base + rstd * (dn*g - mean(dn*g) - xhat * mean(dn*g*xhat)), the
// LayerNorm input gradient added to a residual gradient (out may be base).
__device__ inline void ln_bwd_rows(const float* dn, const float* xhat, const float* rstd,
                                   const bf16* __restrict__ g, int M, int E, const float* base,
                                   float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int m = warp; m < M; m += nwarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = dn[m * E + e] * tof(g[e]);
      s1 += d;
      s2 += d * xhat[m * E + e];
    }
    const float m1 = warp_sum(s1) / E, m2 = warp_sum(s2) / E, r = rstd[m];
    for (int e = lane; e < E; e += 32) {
      const float d = dn[m * E + e] * tof(g[e]);
      out[m * E + e] = base[m * E + e] + r * (d - m1 - xhat[m * E + e] * m2);
    }
  }
  __syncthreads();
}

// out[n] = sum over the M rows, in order, of x[m][n] (* y[m][n] if y):
// one robot's share of a bias / LayerNorm-parameter gradient.
template <class T>
__device__ void colsum(const T* x, int ldx, int M, int N, const float* y, int ldy, float* out) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc += tof(x[m * ldx + n]) * (y != nullptr ? y[m * ldy + n] : 1.f);
    out[n] = acc;
  }
}

// bf16 dst[m][n] = src[m][n]
__device__ inline void to_bf16(const float* src, int lds, int M, int N, bf16* dst, int ldd) {
  for (int i = threadIdx.x; i < M * N; i += blockDim.x)
    dst[(i / N) * ldd + i % N] = __float2bfloat16(src[(i / N) * lds + i % N]);
}

// ------------------------------------------- deterministic weight grads
// C[K, N] = sum over R rows of A[r][:K]^T B[r][:N] (bf16 operands, fp32
// sums), the TPU kernels' full-batch `tdot` contractions. Rows are split
// into fixed chunks of rows_per_split; each chunk's partial C goes to
// `part` (splits, K, N) and a second pass sums the chunks in order, so the
// result does not depend on the schedule.
struct TdotJob {
  const bf16* a;
  const bf16* b;
  float* part;  // (splits, K, N) scratch
  float* out;   // (K, N)
  int lda, ldb, K, N, R;
};

// out[e] = sum over i < n of part[i * len + e], in order of i
struct SumJob {
  const float* part;
  float* out;
  int n, len;
};

__host__ __device__ inline int tdot_splits(int R, int rows_per_split) {
  return (R + rows_per_split - 1) / rows_per_split;
}

// Launch the products, then the ordered sums of their partials and of the
// `extra` sum jobs (the per-robot bias / LayerNorm partials). Returns the
// first CUDA error.
int launch_weight_grads(const TdotJob* jobs, int n_jobs, const SumJob* extra, int n_extra,
                        int rows_per_split, cudaStream_t stream);

}  // namespace sd
