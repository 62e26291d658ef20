// Device helpers of the training kernels (fused_encoder_stack.cu,
// fused_decoder_layer.cu) and the deterministic weight-gradient products
// (weight_grads.cu).
//
// The training kernels run one thread block per robot. Every intermediate a
// robot's layer needs lives in a per-robot global workspace that the block
// writes and reads itself (L1/L2-resident while the block runs); only one
// attention head's (rows x keys) fp32 probability tile sits in shared
// memory. Block-scope __syncthreads() orders those global writes and reads,
// so no pointer into a workspace is __restrict__ (a read-only load path
// would not see writes of the same launch).
//
// Rounding points are the TPU kernels' (soccerdiffusion_tpu/ops/
// fused_encoder_stack.py:_stack_core, fused_decoder_layer.py:_decoder_core
// and their _make_bwd_kernel): LayerNorm, softmax, the residual stream and
// every gradient that feeds a LayerNorm backward or a bias sum in fp32;
// LN outputs, q/k/v, attention outputs, the GELU output and every operand
// of a backward product rounded to bf16; probabilities rounded to bf16
// before a value sum. The attention helpers take the head dimension D (32
// or 64) as a template parameter, the GELU epilogues the activation (exact,
// or quick-GELU z * sigmoid(1.702 z) for the ViT block).
#pragma once

#include "common.cuh"

namespace sd {

// element counts rounded up to 16-byte multiples (fp32 / bf16 workspace regions)
__host__ __device__ inline size_t r4(size_t n) { return (n + 3) & ~(size_t)3; }
__host__ __device__ inline size_t r8(size_t n) { return (n + 7) & ~(size_t)7; }

__device__ __forceinline__ float gelu_cdf(float z) {
  return 0.5f * (1.0f + erff(z * 0.7071067811865476f));
}

// 32 consecutive bf16 (one head's slice of a row; 16-byte aligned) as fp32
__device__ __forceinline__ void load_row32(const bf16* p, float* out) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(pr[j]);
      out[c * 8 + 2 * j] = f.x;
      out[c * 8 + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float dot32(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < 32; ++d) acc += a[d] * b[d];
  return acc;
}

// a (D fp32 values) . b (D consecutive bf16), read 32 elements at a time
template <int D>
__device__ __forceinline__ float dot_row(const float* a, const bf16* b) {
  float bv[32];
  load_row32(b, bv);
  float dot = dot32(a, bv);
#pragma unroll
  for (int c = 1; c < D / 32; ++c) {
    load_row32(b + 32 * c, bv);
    dot += dot32(a + 32 * c, bv);
  }
  return dot;
}

// cdf(z) of GELU(z) = z * cdf(z): the normal CDF, or sigmoid(1.702 z) for
// quick-GELU; and d GELU / dz given cdf(z)
template <bool kQuick>
__device__ __forceinline__ float gelu_gate(float z) {
  return kQuick ? 1.f / (1.f + expf(-1.702f * z)) : gelu_cdf(z);
}
template <bool kQuick>
__device__ __forceinline__ float gelu_slope(float z, float cdf) {
  return kQuick ? cdf * (1.f + 1.702f * z * (1.f - cdf))
                : cdf + z * (expf(-0.5f * z * z) * 0.3989422804014327f);
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
template <bool kQuick = false>
struct GeluStore {  // z = v (fp32), bf16 hg = z * cdf(z)
  float* z;
  int ldz;
  bf16* hg;
  int ldh;
  __device__ void operator()(int m, int n, float v) const {
    z[m * ldz + n] = v;
    hg[m * ldh + n] = __float2bfloat16(v * gelu_gate<kQuick>(v));
  }
};
template <bool kQuick = false>
struct GeluBwd {  // dz = v * GELU'(z) (fp32) and its bf16 copy
  const float* z;
  float* dz;
  int ld;
  bf16* dzc;
  int ldc;
  __device__ void operator()(int m, int n, float v) const {
    const float zz = z[m * ld + n];
    const float d = v * gelu_slope<kQuick>(zz, gelu_gate<kQuick>(zz));
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

// ------------------------------------------------- one attention head
// P[i][j] = softmax_j(q_i . k_j / sqrt(D)), i < nq, j < nk, fp32 scores
// and softmax; q, k are one head's bf16 slices (row strides multiples of 8
// elements). One warp per query row; a key is read 32 elements at a time.
template <int D>
__device__ void head_probs(const bf16* q, int ldq, const bf16* k, int ldk, int nq, int nk,
                           float* P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < nq; i += nwarps) {
    float qv[D];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) load_row32(q + (size_t)i * ldq + 32 * c, qv + 32 * c);
    float* pr = P + i * nk;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float kv[32];
      load_row32(k + (size_t)j * ldk, kv);
      float dot = dot32(qv, kv);
#pragma unroll
      for (int c = 1; c < D / 32; ++c) {
        load_row32(k + (size_t)j * ldk + 32 * c, kv);
        dot += dot32(qv + 32 * c, kv);
      }
      const float s = dot * attn_scale<D>();
      pr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nk; j += 32) pr[j] = pr[j] / sum;
  }
  __syncthreads();
}

// bf16 out[i][d] = sum_j bf16(P[i][j]) v[j][d], d < D
template <int D>
__device__ void head_out(const float* P, int nq, int nk, const bf16* v, int ldv, bf16* out,
                         int ldo) {
  for (int item = threadIdx.x; item < nq * D; item += blockDim.x) {
    const int i = item / D, d = item % D;
    const float* pr = P + i * nk;
    float acc = 0.f;
    for (int j = 0; j < nk; ++j) acc += rbf(pr[j]) * tof(v[(size_t)j * ldv + d]);
    out[(size_t)i * ldo + d] = __float2bfloat16(acc);
  }
  __syncthreads();
}

// Backward of one head given its probabilities P (overwritten by ds) and
// the bf16 gradient of its output, dom (nq, D):
//   dv = bf16(P)^T dom;  dp = dom v^T;  ds = bf16(P (dp - rowsum(dp P)) / sqrt(D));
//   dq = ds k;  dk = ds^T q
// dq, dk, dv are written bf16-rounded; dk32 / dv32 (may be null) receive
// the unrounded fp32 dk / dv (for the key / value bias gradients). One
// warp per query row for ds: a lane holds the row's D-element dom slice
// and reads a value row 32 elements at a time.
template <int D>
__device__ void head_bwd(float* P, int nq, int nk, const bf16* q, int ldq, const bf16* k, int ldk,
                         const bf16* v, int ldv, const bf16* dom, int ldd, bf16* dq, int lddq,
                         bf16* dk, int lddk, bf16* dv, int lddv, float* dk32, float* dv32,
                         int ld32) {
  for (int item = threadIdx.x; item < nk * D; item += blockDim.x) {
    const int j = item / D, d = item % D;
    float acc = 0.f;
    for (int i = 0; i < nq; ++i) acc += rbf(P[i * nk + j]) * tof(dom[(size_t)i * ldd + d]);
    dv[(size_t)j * lddv + d] = __float2bfloat16(acc);
    if (dv32 != nullptr) dv32[(size_t)j * ld32 + d] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int i = warp; i < nq; i += nwarps) {
    float dov[D];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) load_row32(dom + (size_t)i * ldd + 32 * c, dov + 32 * c);
    float* pr = P + i * nk;
    float rs = 0.f;
    for (int j = lane; j < nk; j += 32) rs += dot_row<D>(dov, v + (size_t)j * ldv) * pr[j];
    rs = warp_sum(rs);
    for (int j = lane; j < nk; j += 32)
      pr[j] = rbf(pr[j] * (dot_row<D>(dov, v + (size_t)j * ldv) - rs) * attn_scale<D>());
  }
  __syncthreads();
  for (int item = threadIdx.x; item < nq * D; item += blockDim.x) {
    const int i = item / D, d = item % D;
    const float* pr = P + i * nk;
    float acc = 0.f;
    for (int j = 0; j < nk; ++j) acc += pr[j] * tof(k[(size_t)j * ldk + d]);
    dq[(size_t)i * lddq + d] = __float2bfloat16(acc);
  }
  for (int item = threadIdx.x; item < nk * D; item += blockDim.x) {
    const int j = item / D, d = item % D;
    float acc = 0.f;
    for (int i = 0; i < nq; ++i) acc += P[i * nk + j] * tof(q[(size_t)i * ldq + d]);
    dk[(size_t)j * lddk + d] = __float2bfloat16(acc);
    if (dk32 != nullptr) dk32[(size_t)j * ld32 + d] = acc;
  }
  __syncthreads();
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
