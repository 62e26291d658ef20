// One denoiser pass of the cross-attending decoder for one robot, the
// per-step denoiser's (fused_denoise.cu; the whole-chunk sampler ran it too
// before its pass moved onto the tensor cores in fused_chunk.cu). One thread
// block per robot; everything but the context K/V lives in shared memory.
#pragma once

#include "common.cuh"

namespace sd {

// Packed decoder weights (ops/fused_denoise.py:FusedDenoiser), all bf16,
// Dense kernels as (in, out), per-layer tensors stacked on a leading L axis.
struct DecoderWeights {
  const bf16* emb_w;  // (J, E)
  const bf16* emb_b;  // (E)
  const bf16* pe;     // (P, E) sinusoidal table
  const bf16* qkv_w;  // (L, E, 3E) self-attention q | k | v
  const bf16* qkv_b;  // (L, 3E)
  const bf16* so_w;   // (L, E, E) self-attention out
  const bf16* so_b;   // (L, E)
  const bf16* cq_w;   // (L, E, E) cross-attention q
  const bf16* cq_b;   // (L, E)
  const bf16* co_w;   // (L, E, E) cross-attention out
  const bf16* co_b;   // (L, E)
  const bf16* m1_w;   // (L, E, E)
  const bf16* m1_b;   // (L, E)
  const bf16* m2_w;   // (L, E, E)
  const bf16* m2_b;   // (L, E)
  const bf16* ln_s;   // (L, 3, E) norm1 / norm2 / norm3 scale
  const bf16* ln_b;   // (L, 3, E)
  const bf16* fc_w;   // (E, J)
  const bf16* fc_b;   // (J)
  int L, E, H, P, J;
};

// Shared-memory layout of one decoder pass (all fp32).
struct DecoderSmem {
  float* h;    // (P, E) residual stream
  float* a;    // (P, E) LayerNorm / attention output (bf16-rounded)
  float* qkv;  // (P, 3E + 1) self-attention q | k | v; reused for cross q and the MLP hidden
  float* sc;   // (H, P, S + 1) cross-attention scores / probabilities (16-byte aligned)
  float* xin;  // (P, J4) rounded embedding input, J4 = J rounded up to 4
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// floats of DecoderSmem for P query rows, S context rows
__host__ __device__ inline size_t decoder_smem_floats(int P, int E, int H, int J, int S) {
  return (size_t)P * E * 2 + (size_t)P * round_up4(J) + round_up4(P * (3 * E + 1)) +
         (size_t)H * P * (S + 1);
}

__device__ inline DecoderSmem carve_decoder_smem(float* base, int P, int E, int H, int J, int S) {
  DecoderSmem s;
  s.h = base;
  s.a = s.h + P * E;
  s.xin = s.a + P * E;
  s.qkv = s.xin + P * round_up4(J);
  s.sc = s.qkv + round_up4(P * (3 * E + 1));  // 16-byte aligned: the chunk kernel stages tiles here
  return s;
}

// Cross-attention of the P query rows q (P, E) over S context keys plus the
// step-token key shared by all robots, which enters the SAME softmax as
// column S. ctx_k / ctx_v: (S, E) bf16 rows of this robot in global memory
// (L2 / HBM: they do not fit on chip; not __restrict__, since the chunk
// kernel writes them earlier in the same launch); stk / stv: (E) bf16.
// D is the head dimension.
template <int D>
__device__ void cross_attention(const float* __restrict__ q, const bf16* ctx_k, const bf16* ctx_v,
                                const bf16* __restrict__ stk, const bf16* __restrict__ stv, int P,
                                int S, int E, int H, float* __restrict__ sc,
                                float* __restrict__ out) {
  const int S1 = S + 1;
  // scores: one thread per (key, head) loads the key's D-element head
  // slice once (2D bytes) and scores it against all P queries
  for (int item = threadIdx.x; item < S1 * H; item += blockDim.x) {
    const int s = item % S1, hh = item / S1;
    const bf16* kr = (s < S ? ctx_k + (size_t)s * E : stk) + hh * D;
    float k[D];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(kr)[c];
      const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(pr[j]);
        k[c * 8 + 2 * j] = f.x;
        k[c * 8 + 2 * j + 1] = f.y;
      }
    }
    for (int p = 0; p < P; ++p) {
      const float4* qr = reinterpret_cast<const float4*>(q + p * E + hh * D);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        acc += qv.x * k[4 * d4] + qv.y * k[4 * d4 + 1] + qv.z * k[4 * d4 + 2] + qv.w * k[4 * d4 + 3];
      }
      sc[(hh * P + p) * S1 + s] = acc * attn_scale<D>();
    }
  }
  __syncthreads();
  // softmax: one warp per (head, query) row of S + 1 scores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int row = warp; row < H * P; row += nwarps) {
    float* r = sc + row * S1;
    float mx = -INFINITY;
    for (int s = lane; s < S1; s += 32) mx = fmaxf(mx, r[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S1; s += 32) {
      const float e = expf(r[s] - mx);
      r[s] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();
    for (int s = lane; s < S1; s += 32) r[s] = rbf(r[s] * inv);
  }
  __syncthreads();
  // values: one thread per (feature column, chunk of up to 5 query rows);
  // the 32 threads of a warp read one head's 64-byte value row slice
  constexpr int PC = 5;
  const int n_pc = (P + PC - 1) / PC;
  for (int item = threadIdx.x; item < E * n_pc; item += blockDim.x) {
    const int e = item % E, p0 = (item / E) * PC;
    const int hh = e / D;
    const int rows = min(PC, P - p0);
    const float* pr[PC];
#pragma unroll
    for (int i = 0; i < PC; ++i) pr[i] = sc + (hh * P + p0 + min(i, rows - 1)) * S1;
    float acc[PC];
#pragma unroll
    for (int i = 0; i < PC; ++i) acc[i] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float v = tof(ctx_v[(size_t)s * E + e]);
#pragma unroll
      for (int i = 0; i < PC; ++i) acc[i] += pr[i][s] * v;
    }
    const float v = tof(stv[e]);
#pragma unroll
    for (int i = 0; i < PC; ++i) acc[i] += pr[i][S] * v;
#pragma unroll
    for (int i = 0; i < PC; ++i)
      if (i < rows) out[(p0 + i) * E + e] = rbf(acc[i]);
  }
  __syncthreads();
}

// eps (P, J) of the decoder for one robot: x (P, J) fp32 in shared memory
// (the current noisy chunk), per-layer context K/V at ctx_k + l * kv_layer_stride
// (S, E rows), per-layer step-token K/V rows at stk + l * E. Writes eps
// through epi(p, j, eps). D = E / H is the head dimension.
template <int D, class Epi>
__device__ void decoder_pass(const DecoderWeights& w, const DecoderSmem& sm, const float* x,
                             const bf16* ctx_k, const bf16* ctx_v, size_t kv_layer_stride,
                             const bf16* stk, const bf16* stv, int S, Epi epi) {
  const int E = w.E, P = w.P, J = w.J, H = w.H, J4 = round_up4(w.J);
  const int LDQ = 3 * E + 1;
  for (int i = threadIdx.x; i < P * J; i += blockDim.x)
    sm.xin[(i / J) * J4 + i % J] = rbf(x[i]);
  __syncthreads();
  // embedding + positional encoding into the fp32 residual stream
  dense<5, 1>(sm.xin, J4, P, J, w.emb_w, E, w.emb_b, EmbedEpi{sm.h, w.pe, E});
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const size_t EE = (size_t)E * E;
    const bf16* ln_s = w.ln_s + (size_t)l * 3 * E;
    const bf16* ln_b = w.ln_b + (size_t)l * 3 * E;
    // self-attention
    layer_norm_rows(sm.h, E, P, E, ln_s, ln_b, sm.a, E);
    __syncthreads();
    dense<5, 1>(sm.a, E, P, E, w.qkv_w + l * 3 * EE, 3 * E, w.qkv_b + (size_t)l * 3 * E,
                StoreRound{sm.qkv, LDQ});
    __syncthreads();
    self_attention<D>(sm.qkv, LDQ, P, E, H, sm.a, E);
    __syncthreads();
    dense<5, 1>(sm.a, E, P, E, w.so_w + l * EE, E, w.so_b + (size_t)l * E, AddTo{sm.h, E});
    __syncthreads();
    // cross-attention: cached context K/V + the shared step-token column
    layer_norm_rows(sm.h, E, P, E, ln_s + E, ln_b + E, sm.a, E);
    __syncthreads();
    dense<5, 1>(sm.a, E, P, E, w.cq_w + l * EE, E, w.cq_b + (size_t)l * E, StoreRound{sm.qkv, E});
    __syncthreads();
    cross_attention<D>(sm.qkv, ctx_k + l * kv_layer_stride, ctx_v + l * kv_layer_stride,
                       stk + (size_t)l * E, stv + (size_t)l * E, P, S, E, H, sm.sc, sm.a);
    dense<5, 1>(sm.a, E, P, E, w.co_w + l * EE, E, w.co_b + (size_t)l * E, AddTo{sm.h, E});
    __syncthreads();
    // MLP
    layer_norm_rows(sm.h, E, P, E, ln_s + 2 * E, ln_b + 2 * E, sm.a, E);
    __syncthreads();
    dense<5, 1>(sm.a, E, P, E, w.m1_w + l * EE, E, w.m1_b + (size_t)l * E,
                StoreGeluRound{sm.qkv, E});
    __syncthreads();
    dense<5, 1>(sm.qkv, E, P, E, w.m2_w + l * EE, E, w.m2_b + (size_t)l * E, AddTo{sm.h, E});
    __syncthreads();
  }
  // output projection of the bf16-rounded residual stream
  for (int i = threadIdx.x; i < P * E; i += blockDim.x) sm.a[i] = rbf(sm.h[i]);
  __syncthreads();
  dense<5, 1>(sm.a, E, P, E, w.fc_w, J, w.fc_b, epi);
  __syncthreads();
}

}  // namespace sd
