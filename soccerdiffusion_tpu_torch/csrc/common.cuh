// Shared device helpers for the serving and training kernels (sm_90a).
//
// Conventions of every kernel in this directory:
//   * weights, biases, LayerNorm params and context tokens are bf16 in
//     global memory; arithmetic is fp32;
//   * the residual stream stays fp32 in shared memory;
//   * every matmul input (LayerNorm output, attention output, GELU output)
//     and q / k / v are rounded to bf16 (round-to-nearest-even) and kept as
//     fp32 values, so a product is exactly a bf16 x bf16 product and sums
//     accumulate in fp32 -- the same rounding points as the plain PyTorch
//     versions beside the kernels;
//   * attention: fp32 scores and softmax, probabilities rounded to bf16
//     after normalisation, fp32 value sums;
//   * the head dimension D is a template parameter, 32 or 64 (head_dim()
//     below): a warp lane holds D / 32 elements of a head, lanes j and
//     j + 32 apart; the attention scale is 1 / sqrt(D).
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
  static_assert(D == 32 || D == 64, "the kernels take head_dim 32 or 64");
  return D == 32 ? 0.17677669529663687f : 0.125f;
}

// The head dimension E / H if a kernel instance exists for it (32 or 64), else 0.
__host__ __device__ inline int head_dim(int E, int H) {
  return (H > 0 && (E == 32 * H || E == 64 * H)) ? E / H : 0;
}

__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Epilogues of dense(): called once per output element with the fp32 sum
// (bias included).
struct StoreRound {  // out[m][n] = bf16-rounded v
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = rbf(v); }
};
struct StoreRoundBf16 {  // bf16 out[m][n] = v
  bf16* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = __float2bfloat16(v); }
};
struct StoreGeluRound {  // out[m][n] = bf16-rounded exact GELU(v)
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = rbf(gelu_exact(v)); }
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

// Four consecutive X elements as fp32 (16-byte fp32 or 8-byte bf16 load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Y[M, N] = X[M, K] . W[K, N] + bias[N], handed to epi(m, n, y).
// X: fp32 or bf16, row stride ldx (a multiple of 4, rows aligned to 4
// elements), in shared memory or in a global workspace the block wrote
// earlier (so X is not __restrict__: a read-only load path would not see
// those writes). W: bf16 row-major (K, N) in global memory (L2-resident:
// every block of the grid reads the same weights). A `nullptr` bias
// selects the overload without one (a runtime null check instead cost the
// serving kernels registers and spills). Each
// thread owns MT rows x NC adjacent columns per work item; the threads of a
// warp take adjacent columns of the same rows, so X reads are broadcasts
// and W reads are coalesced.
template <int MT, int NC, bool kBias, class Epi, class XT>
__device__ void dense_impl(const XT* X, int ldx, int M, int K, const bf16* __restrict__ W, int N,
                           const bf16* __restrict__ bias, Epi epi) {
  const int n_groups = N / NC;
  const int n_items = n_groups * ((M + MT - 1) / MT);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int n0 = (item % n_groups) * NC;
    const int m0 = (item / n_groups) * MT;
    const int rows = min(MT, M - m0);
    const XT* xr[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) xr[i] = X + (m0 + min(i, rows - 1)) * ldx;
    float acc[MT][NC];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      float w[4][NC];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* wp = W + (size_t)(k + j) * N + n0;
        if constexpr (NC == 2) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wp));
          w[j][0] = f.x;
          w[j][1] = f.y;
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) w[j][c] = tof(wp[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float4 xv = load4(xr[i] + k);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] += xv.x * w[0][c] + xv.y * w[1][c] + xv.z * w[2][c] + xv.w * w[3][c];
      }
    }
    for (; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float wv = tof(W[(size_t)k * N + n0 + c]);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][c] += tof(xr[i][k]) * wv;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < rows) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if constexpr (kBias) {
            epi(m0 + i, n0 + c, acc[i][c] + tof(bias[n0 + c]));
          } else {
            epi(m0 + i, n0 + c, acc[i][c]);
          }
        }
      }
    }
  }
}

template <int MT, int NC, class Epi, class XT = float>
__device__ void dense(const XT* X, int ldx, int M, int K, const bf16* __restrict__ W, int N,
                      const bf16* __restrict__ bias, Epi epi) {
  dense_impl<MT, NC, true>(X, ldx, M, K, W, N, bias, epi);
}
template <int MT, int NC, class Epi, class XT = float>
__device__ void dense(const XT* X, int ldx, int M, int K, const bf16* __restrict__ W, int N,
                      std::nullptr_t, Epi epi) {
  dense_impl<MT, NC, false>(X, ldx, M, K, W, N, nullptr, epi);
}

__device__ __forceinline__ void store_rounded(float* p, float v) { *p = rbf(v); }
__device__ __forceinline__ void store_rounded(bf16* p, float v) { *p = __float2bfloat16(v); }

// out[m] = bf16-rounded LayerNorm(x[m]) * scale + bias over E features,
// fp32 statistics (mean, then mean of squared deviations), one warp per row;
// out is fp32 (holding bf16 values) or bf16.
template <class OutT>
__device__ void layer_norm_rows(const float* __restrict__ x, int ldx, int M, int E,
                                const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                                OutT* __restrict__ out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int m = warp; m < M; m += nwarps) {
    const float* xr = x + m * ldx;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += xr[e];
    const float mean = warp_sum(s) / E;
    float v = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = xr[e] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / E + kLnEps);
    for (int e = lane; e < E; e += 32)
      store_rounded(out + m * ldo + e, (xr[e] - mean) * inv * tof(scale[e]) + tof(bias[e]));
  }
}

// Unmasked multi-head self-attention over n <= 128 rows held in shared
// memory as qkv[row][0:E | E:2E | 2E:3E] (row stride ld, an odd number of
// 32-bit words so that lanes reading different rows hit different banks).
// One warp per (row, head): lane j scores keys j, j+32, j+64, j+96; lane d
// then sums the values of head elements d (and d + 32 at D = 64). Writes the
// bf16-rounded output to out[row][head * D + d].
template <int D, class T>
__device__ void self_attention(const T* __restrict__ qkv, int ld, int n, int E, int H,
                               float* __restrict__ out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int item = warp; item < n * H; item += nwarps) {
    const int i = item / H, hh = item % H;
    const T* q = qkv + i * ld + hh * D;
    float s[4];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      s[c] = -INFINITY;
      if (j < n) {
        const T* kr = qkv + j * ld + E + hh * D;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += tof(q[d]) * tof(kr[d]);
        s[c] = acc * attn_scale<D>();
      }
      mx = fmaxf(mx, s[c]);
    }
    mx = warp_max(mx);
    float p[4], sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[c] = (lane + 32 * c < n) ? expf(s[c] - mx) : 0.f;
      sum += p[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] = rbf(p[c] / sum);
    float acc[D / 32];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[e] = 0.f;
    const T* vcol = qkv + 2 * E + hh * D + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (32 * c >= n) break;
      for (int src = 0; src < 32; ++src) {
        const float pj = __shfl_sync(0xffffffffu, p[c], src);
        const int j = 32 * c + src;
        if (j < n) {
#pragma unroll
          for (int e = 0; e < D / 32; ++e) acc[e] += pj * tof(vcol[j * ld + 32 * e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < D / 32; ++e) out[i * ldo + hh * D + 32 * e + lane] = rbf(acc[e]);
  }
}

}  // namespace sd
