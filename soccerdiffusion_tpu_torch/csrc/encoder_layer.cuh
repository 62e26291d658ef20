// One pre-norm encoder layer for one thread block, forward and backward,
// shared by the fused encoder stack (fused_encoder_stack.cu, exact GELU, L
// layers) and the fused ViT block (fused_vit_block.cu, one layer, exact or
// quick GELU):
//   x2 = x + attn(LN1(x)) @ wo + bo;  y = x2 + gelu(LN2(x2) @ w1 + b1) @ w2 + b2
// D is the head dimension, kQuick selects quick-GELU. Two forms:
//   * layer_fwd_smem, the forward kernels' layer: every bf16 operand in
//     shared memory (A fragments and k / v^T by ldmatrix), the fp32 residual
//     where the caller keeps it;
//   * layer_fwd (the backward's recompute) and layer_bwd: every intermediate
//     in the block's own global workspace (EncWs), the weight-gradient
//     operands in its rows of a `saved` buffer (stride WS = 8E + 2FF: n1
//     dqkv om da n2 dzc hg gc).
//
// Every product runs on the tensor cores (mma.cuh): the dense products as
// mma_dense (A in shared memory) or mma_dense_rows (A in the workspace)
// warp items, B read from the weights in L2 with the reduction axis
// contiguous -- the transposed copies (out, in) for the forward products,
// the (in, out) originals for the backward's input-gradient products -- and
// attention per (head, 16-row tile) with the scores in
// registers. The backward's attention needs the softmax statistics of every
// query row across warps: 3 H T floats of shared memory (stats). What bounds
// the backward now is the workspace traffic and the scalar row passes
// (LayerNorm, column sums), not the products.
#pragma once

#include "mma.cuh"

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

// One layer's bf16 weights (Dense kernels (in, out)) and the transposed
// kernels (out, in), which the forward products read
struct EncLayer {
  const bf16 *g1, *be1, *wqkv, *bqkv, *wo, *bo, *g2, *be2, *w1, *b1, *w2, *b2;
  const bf16 *wqkv_t, *wo_t, *w1_t, *w2_t;
};

template <bool kQuick>
struct GeluBf16 {  // bf16 out[m][n] = z * cdf(z) of the fp32 sum z
  bf16* out;
  int ld;
  __device__ void operator()(int m, int n, float z) const {
    out[m * ld + n] = __float2bfloat16(z * gelu_gate<kQuick>(z));
  }
};

// bf16 out = LayerNorm(x) * g + b with fp32 statistics, one warp per row (x
// with row stride E, in shared memory or in global memory this block wrote:
// not __restrict__, so that no read-only load path skips those writes)
__device__ inline void ln_bf16_rows(const float* x, int M, int E, const bf16* __restrict__ g,
                                    const bf16* __restrict__ b, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int m = warp; m < M; m += nwarps) {
    const float* xr = x + (size_t)m * E;
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += xr[e];
    const float mean = warp_sum(s) / E;
    float v = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float d = xr[e] - mean;
      v += d * d;
    }
    const float r = rsqrtf(warp_sum(v) / E + kLnEps);
    for (int e = lane; e < E; e += 32)
      out[m * ldo + e] = __float2bfloat16((xr[e] - mean) * r * tof(g[e]) + tof(b[e]));
  }
}

// The columns of one forward MLP chunk: at most 256, and at most 3E so that
// a (T, chunk + 8) bf16 tile fits the q|k|v region
__host__ __device__ inline int mlp_chunk(int E, int FF) {
  const int fc = FF < 256 ? FF : 256;
  return fc < 3 * E ? fc : 3 * E;
}

// The forward kernels' threads: 16 warps a frame or robot (at most 128
// registers a thread), so that a layer's mma items spread over twice the
// warps of the backward, whose attention tiles take up to 255 registers at
// 8 warps
constexpr int kFwdThreads = 512;

// Shared-memory bytes of layer_fwd_smem's operands: act (T, E + 8) and q|k|v
// (T, 3E + 8), bf16
__host__ __device__ inline size_t fwd_smem_bytes(int T, int E) {
  return 2 * (size_t)T * ((E + 8) + (3 * E + 8));
}

// One layer's forward for one block with every bf16 operand in shared
// memory (the forward kernels of the ViT block and of the stack): x (T, E)
// fp32 in, h (T, E) fp32 out (x may be h; either in shared memory or in a
// global buffer this block owns). act (T, E + 8) holds LN1(x), the heads'
// outputs, then LN2(x2); qkv (T, 3E + 8) holds q|k|v, then one MLP chunk of
// mlp_chunk(E, FF) hidden columns, whose share of the second product is
// added into h (b2 with the first). Rows are padded by 8 elements so that
// the 8 rows of an ldmatrix hit 8 different bank quads. The products are
// mma_dense over 64-row x 16-column warp items (each weight read from L2
// once per 64 rows), attention per (head, 16-query tile) with the scores in
// registers. Ends with __syncthreads.
template <int D, bool kQuick>
__device__ void layer_fwd_smem(const EncLayer& w, const float* x, float* h, bf16* act, bf16* qkv,
                               int T, int E, int FF, int H) {
  const int lda = E + 8, ldq = 3 * E + 8, fc = mlp_chunk(E, FF), ldh = fc + 8;
  ln_bf16_rows(x, T, E, w.g1, w.be1, act, lda);
  __syncthreads();
  mma_dense<4, 2>(act, lda, T, E, w.wqkv_t, E, 3 * E, w.bqkv, StoreRoundBf16{qkv, ldq});
  __syncthreads();
  attention_fwd<D, true>(qkv, ldq, T, E, H, act, lda);
  __syncthreads();
  mma_dense<4, 2>(act, lda, T, E, w.wo_t, E, E, w.bo, AddStore{x, h, E});
  __syncthreads();
  ln_bf16_rows(h, T, E, w.g2, w.be2, act, lda);
  __syncthreads();
  for (int f0 = 0; f0 < FF; f0 += fc) {
    const int n = min(fc, FF - f0);
    mma_dense<4, 2>(act, lda, T, E, w.w1_t + (size_t)f0 * E, E, n, w.b1 + f0,
                          GeluBf16<kQuick>{qkv, ldh});
    __syncthreads();
    if (f0 == 0) {
      mma_dense<4, 2>(qkv, ldh, T, n, w.w2_t, FF, E, w.b2, AddTo{h, E});
    } else {
      mma_dense<4, 2>(qkv, ldh, T, n, w.w2_t + f0, FF, E, nullptr, AddTo{h, E});
    }
    __syncthreads();
  }
}

// One layer's forward for one block: x (T, E) fp32 -> y (T, E) fp32,
// leaving n1 / om / n2 / hg in the saved row `sv` (stride WS) and q|k|v,
// xhat, rstd, x2, z in the workspace for the backward.
template <int D, bool kQuick>
__device__ void layer_fwd(const EncLayer& w, const EncWs& s, bf16* sv, int WS, const float* x,
                          float* y, int T, int E, int FF, int H) {
  bf16 *n1 = sv, *om = sv + 4 * E, *n2 = sv + 6 * E, *hg = sv + 7 * E + FF;
  ln_rows(x, T, E, w.g1, w.be1, n1, WS, s.xh1, s.r1);
  mma_dense_rows(n1, WS, T, E, w.wqkv_t, E, 3 * E, w.bqkv, StoreRoundBf16{s.qkv, 3 * E});
  __syncthreads();
  attention_fwd<D>(s.qkv, 3 * E, T, E, H, om, WS);
  __syncthreads();
  mma_dense_rows(om, WS, T, E, w.wo_t, E, E, w.bo, AddStore{x, s.x2, E});
  __syncthreads();
  ln_rows(s.x2, T, E, w.g2, w.be2, n2, WS, s.xh2, s.r2);
  mma_dense_rows(n2, WS, T, E, w.w1_t, E, FF, w.b1, GeluStore<kQuick>{s.z, FF, hg, WS});
  __syncthreads();
  mma_dense_rows(hg, WS, T, FF, w.w2_t, FF, E, w.b2, AddStore{s.x2, y, E});
  __syncthreads();
}

// One layer's backward for one block after layer_fwd: s.g holds dL/dy on
// entry and dL/dx on exit. Writes the bf16 operands of the weight-gradient
// products into the saved row and this block's bias / LN partials to vp
// (g1 0, be1 E, bqkv 2E, bo 5E, g2 6E, be2 7E, b1 8E, b2 8E + FF); stats:
// 3 H T floats of shared memory.
template <int D, bool kQuick>
__device__ void layer_bwd(const EncLayer& w, const EncWs& s, bf16* sv, int WS, float* stats,
                          float* vp, int T, int E, int FF, int H) {
  bf16 *dqkv = sv + E, *da = sv + 5 * E, *dzc = sv + 7 * E, *gc = sv + 7 * E + 2 * FF;
  // MLP: dhg = g w2^T; dz = dhg GELU'(z); dn2 = dz w1^T
  to_bf16(s.g, E, T, E, gc, WS);
  colsum(s.g, E, T, E, nullptr, 0, vp + 8 * E + FF);
  __syncthreads();
  mma_dense_rows(gc, WS, T, E, w.w2, E, FF, nullptr, GeluBwd<kQuick>{s.z, s.dz, FF, dzc, WS});
  __syncthreads();
  colsum(s.dz, FF, T, FF, nullptr, 0, vp + 8 * E);
  mma_dense_rows(dzc, WS, T, FF, w.w1, FF, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh2, E, vp + 6 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 7 * E);
  ln_bwd_rows(s.tmp, s.xh2, s.r2, w.g2, T, E, s.g, s.dx2);
  to_bf16(s.dx2, E, T, E, da, WS);
  colsum(s.dx2, E, T, E, nullptr, 0, vp + 5 * E);
  __syncthreads();
  // attention: dom = da wo^T, then every head
  mma_dense_rows(da, WS, T, E, w.wo, E, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  attention_bwd<D>(s.qkv, 3 * E, s.dom, E, T, E, H, dqkv, WS, stats);
  colsum(dqkv, WS, T, 3 * E, nullptr, 0, vp + 2 * E);
  mma_dense_rows(dqkv, WS, T, 3 * E, w.wqkv, 3 * E, E, nullptr, StoreF32{s.tmp, E});
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
