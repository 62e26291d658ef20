// One pre-norm encoder layer for one thread block, forward and backward,
// shared by the fused encoder stack (fused_encoder_stack.cu, exact GELU, L
// layers) and the fused ViT block's backward (fused_vit_block.cu, one layer,
// exact or quick GELU):
//   x2 = x + attn(LN1(x)) @ wo + bo;  y = x2 + gelu(LN2(x2) @ w1 + b1) @ w2 + b2
// Every intermediate lives in the block's own global workspace (EncWs), the
// weight-gradient operands in its rows of a `saved` buffer (stride WS = 8E +
// 2FF: n1 dqkv om da n2 dzc hg gc), one head's fp32 probabilities in shared
// memory (P). D is the head dimension, kQuick selects quick-GELU.
#pragma once

#include "train_common.cuh"

namespace sd {

struct EncWs {  // one block's workspace
  float *g, *x2, *xh1, *xh2, *tmp, *dx2, *z, *dz, *r1, *r2;
  bf16 *qkv, *dom;
};

// Carves one block's workspace (when f / h are given) and returns the fp32
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

// One layer's bf16 weights (Dense kernels (in, out)) and, for the backward,
// the transposed kernels
struct EncLayer {
  const bf16 *g1, *be1, *wqkv, *bqkv, *wo, *bo, *g2, *be2, *w1, *b1, *w2, *b2;
  const bf16 *wqkv_t, *wo_t, *w1_t, *w2_t;
};

// One layer's forward for one block: x (T, E) fp32 -> y (T, E) fp32,
// leaving n1 / om / n2 / hg in the saved row `sv` (stride WS) and q|k|v,
// xhat, rstd, x2, z in the workspace for the backward.
template <int D, bool kQuick>
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
  dense<8, 2>(n2, WS, T, E, w.w1, FF, w.b1, GeluStore<kQuick>{s.z, FF, hg, WS});
  __syncthreads();
  dense<8, 2>(hg, WS, T, FF, w.w2, E, w.b2, AddStore{s.x2, y, E});
  __syncthreads();
}

// One layer's backward for one block after layer_fwd: s.g holds dL/dy on
// entry and dL/dx on exit. Writes the bf16 operands of the weight-gradient
// products into the saved row and this block's bias / LN partials to vp
// (g1 0, be1 E, bqkv 2E, bo 5E, g2 6E, be2 7E, b1 8E, b2 8E + FF).
template <int D, bool kQuick>
__device__ void layer_bwd(const EncLayer& w, const EncWs& s, bf16* sv, int WS, float* P,
                          float* vp, int T, int E, int FF, int H) {
  bf16 *dqkv = sv + E, *da = sv + 5 * E, *dzc = sv + 7 * E, *gc = sv + 7 * E + 2 * FF;
  // MLP: dhg = g w2^T; dz = dhg GELU'(z); dn2 = dz w1^T
  to_bf16(s.g, E, T, E, gc, WS);
  colsum(s.g, E, T, E, nullptr, 0, vp + 8 * E + FF);
  __syncthreads();
  dense<8, 2>(gc, WS, T, E, w.w2_t, FF, nullptr, GeluBwd<kQuick>{s.z, s.dz, FF, dzc, WS});
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
    const int o = h * D;
    const bf16* q = s.qkv + o;
    head_probs<D>(q, 3 * E, q + E, 3 * E, T, T, P);
    head_bwd<D>(P, T, T, q, 3 * E, q + E, 3 * E, q + 2 * E, 3 * E, s.dom + o, E, dqkv + o, WS,
                dqkv + E + o, WS, dqkv + 2 * E + o, WS, nullptr, nullptr, 0);
  }
  colsum(dqkv, WS, T, 3 * E, nullptr, 0, vp + 2 * E);
  dense<8, 2>(dqkv, WS, T, 3 * E, w.wqkv_t, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh1, E, vp);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + E);
  ln_bwd_rows(s.tmp, s.xh1, s.r1, w.g1, T, E, s.dx2, s.g);
}

// The four weight-gradient products of one layer's saved rows (R rows,
// stride 8E + 2FF) -- dwqkv (E, 3E), dwo (E, E), dw1 (E, FF), dw2 (FF, E)
// into mats[0..3] -- with their (splits, K, N) partials from tpart; returns
// the fp32 elements of tpart they take.
inline size_t layer_tdot_jobs(const bf16* rows, int R, int E, int FF, float* const* mats,
                              float* tpart, int rows_per_split, TdotJob* jobs) {
  const int WS = 8 * E + 2 * FF;
  const int cols[4][2] = {{0, E}, {4 * E, 5 * E}, {6 * E, 7 * E}, {7 * E + FF, 7 * E + 2 * FF}};
  const int KN[4][2] = {{E, 3 * E}, {E, E}, {E, FF}, {FF, E}};
  size_t off = 0;
  for (int j = 0; j < 4; ++j) {
    const int K = KN[j][0], N = KN[j][1];
    jobs[j] = TdotJob{rows + cols[j][0], rows + cols[j][1], tpart + off, mats[j], WS, WS, K, N, R};
    off += (size_t)tdot_splits(R, rows_per_split) * K * N;
  }
  return off;
}

}  // namespace sd
