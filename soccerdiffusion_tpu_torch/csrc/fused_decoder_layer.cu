// Fused cross-attending decoder layer for training: forward (kernel A) and
// hand-written backward with recompute (kernel B), one thread block per
// robot.
//
// Replaces soccerdiffusion_tpu/ops/fused_decoder_layer.py:
// make_decoder_layer_fn (_fwd_impl, _make_fwd_kernel / _decoder_core; and
// _bwd_impl, _make_bwd_kernel).
//
// Bound on the H100: per robot at T=10 chunk rows, S=302 memory rows,
// E=FF=128 the forward is ~23 MFLOP, ~85% of it the in-kernel projection of
// the memory's K/V (S x E x 2E); the backward recomputes the forward and
// adds ~3x that. Scalar fp32 FMAs, compute- and latency-bound. Design:
//   * one robot's cross K and V (2 x 302 x 128 bf16 = 155 KB) and the
//     (T x S) scores do not fit beside the rest in 227 KB of shared memory
//     (the TPU kernel keeps a 32-robot block in 110 MB of VMEM): K/V and
//     every other intermediate go to a per-robot global workspace that the
//     block writes and re-reads (L1/L2-resident while it runs); one head's
//     (T x S) fp32 probability tile sits in shared memory, and the backward
//     recomputes it head by head;
//   * the weight gradients (dwck / dwcv over B*S memory rows, the others
//     over B*T chunk rows) are `tdot` products of bf16 operands this kernel
//     writes, summed over the batch in a fixed order by weight_grads.cu, as
//     are the per-robot bias / LayerNorm partials (no race, no atomics);
//   * no 8-row padding or key-column mask (T rows as they are), no
//     lane-masked head stacking, erff for the exact GELU;
//   * forward and backward have instances for head_dim 32 (h128) and 64
//     (the flagship: E=256, 4 heads, S=311 memory rows; its (T x S)
//     probability tile is 12 KB of shared memory, its per-robot workspace
//     grows with S x E).
#include "train_common.cuh"

namespace sd {

struct DecArgs {
  const bf16* x;    // (B, T, E)
  const bf16* mem;  // (B, S, E)
  const bf16* dy;   // bwd: (B, T, E)
  bf16* out;        // fwd: y; bwd: dx (B, T, E)
  bf16* dmem;       // bwd: (B, S, E)
  // g1 be1 wqkv bqkv wso bso g2 be2 wcq bcq wck bck wcv bcv wco bco g3 be3 w1 b1 w2 b2
  const bf16* w[22];
  // bwd: transposed wqkv wso wcq wck wcv wco w1 w2
  const bf16* wt[8];
  float* ws32;      // (B, ws32_stride)
  bf16* wsbf;       // (B, wsbf_stride)
  bf16* saved;      // (B*T, 12E + 2FF) rows: n1 dqkv om1 da1 n2 dq2c om2 da2 n3 gc dzc hg
  bf16* saved_mem;  // bwd: (B*S, 2E) rows: dk2c dv2c
  float* vpart;     // bwd: (B, 15E + FF)
  int B, T, S, E, H, FF, ws32_stride, wsbf_stride;
};

struct DecWs {  // one robot's workspace
  float *x, *x2, *x3, *xh1, *xh2, *xh3, *tmp, *ga, *gb, *g, *z, *dz, *r1, *r2, *r3;
  float *dk32, *dv32, *tmpS;
  bf16 *qkv, *q2, *dom, *k2, *v2;
};

// Carves one robot's workspace (when f / h are given) and returns the fp32
// and bf16 elements it needs (ops/fused_decoder_layer.py:_ws_strides).
__host__ __device__ inline void dec_carve(int T, int S, int E, int FF, float* f, bf16* h,
                                          DecWs* w, size_t* n32, size_t* nbf) {
  const size_t te = r4((size_t)T * E), tf = r4((size_t)T * FF), t = r4(T), se = r4((size_t)S * E);
  const size_t te8 = r8((size_t)T * E), se8 = r8((size_t)S * E), q8 = r8((size_t)3 * T * E);
  *n32 = 10 * te + 2 * tf + 3 * t + 3 * se;
  *nbf = q8 + 2 * te8 + 2 * se8;
  if (w == nullptr) return;
  float* p = f;
  float** fp[10] = {&w->x, &w->x2, &w->x3, &w->xh1, &w->xh2, &w->xh3, &w->tmp, &w->ga, &w->gb, &w->g};
  for (int i = 0; i < 10; ++i, p += te) *fp[i] = p;
  w->z = p;
  w->dz = p + tf;
  p += 2 * tf;
  w->r1 = p;
  w->r2 = p + t;
  w->r3 = p + 2 * t;
  p += 3 * t;
  w->dk32 = p;
  w->dv32 = p + se;
  w->tmpS = p + 2 * se;
  w->qkv = h;
  w->q2 = h + q8;
  w->dom = h + q8 + te8;
  w->k2 = h + q8 + 2 * te8;
  w->v2 = h + q8 + 2 * te8 + se8;
}

struct DecLayer {
  const bf16 *g1, *be1, *wqkv, *bqkv, *wso, *bso, *g2, *be2, *wcq, *bcq, *wck, *bck, *wcv, *bcv,
      *wco, *bco, *g3, *be3, *w1, *b1, *w2, *b2;
  const bf16 *wqkv_t, *wso_t, *wcq_t, *wck_t, *wcv_t, *wco_t, *w1_t, *w2_t;
};

static_assert(sizeof(DecLayer) == 30 * sizeof(const bf16*), "DecLayer is 30 pointers");

__device__ inline DecLayer dec_weights(const DecArgs& a) {
  DecLayer w;
  const bf16** p = &w.g1;  // the 22 weights, then the 8 transposed ones, in order
  for (int i = 0; i < 22; ++i) p[i] = a.w[i];
  for (int i = 0; i < 8; ++i) p[22 + i] = a.wt[i];
  return w;
}

// Column offsets in a saved chunk row
struct DecCols {
  int n1, dqkv, om1, da1, n2, dq2c, om2, da2, n3, gc, dzc, hg, W;
  __host__ __device__ DecCols(int E, int FF)
      : n1(0), dqkv(E), om1(4 * E), da1(5 * E), n2(6 * E), dq2c(7 * E), om2(8 * E), da2(9 * E),
        n3(10 * E), gc(11 * E), dzc(12 * E), hg(12 * E + FF), W(12 * E + 2 * FF) {}
};

// The layer's forward for one robot: x (T, E) and mem (S, E) bf16 -> y32
// (T, E) fp32, leaving every intermediate the backward needs in the saved
// row and the workspace.
template <int D>
__device__ void dec_fwd(const DecLayer& w, const DecWs& s, bf16* sv, const bf16* x,
                        const bf16* mem, float* y32, float* P, int T, int S, int E, int FF, int H) {
  const DecCols c(E, FF);
  const int W = c.W;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) s.x[i] = tof(x[i]);
  __syncthreads();
  // self-attention
  ln_rows(s.x, T, E, w.g1, w.be1, sv + c.n1, W, s.xh1, s.r1);
  dense<5, 2>(sv + c.n1, W, T, E, w.wqkv, 3 * E, w.bqkv, StoreRoundBf16{s.qkv, 3 * E});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const bf16* q = s.qkv + h * D;
    head_probs<D>(q, 3 * E, q + E, 3 * E, T, T, P);
    head_out<D>(P, T, T, q + 2 * E, 3 * E, sv + c.om1 + h * D, W);
  }
  dense<5, 2>(sv + c.om1, W, T, E, w.wso, E, w.bso, AddStore{s.x, s.x2, E});
  __syncthreads();
  // cross-attention with the memory's K / V projected here
  ln_rows(s.x2, T, E, w.g2, w.be2, sv + c.n2, W, s.xh2, s.r2);
  dense<5, 2>(sv + c.n2, W, T, E, w.wcq, E, w.bcq, StoreRoundBf16{s.q2, E});
  dense<8, 2>(mem, E, S, E, w.wck, E, w.bck, StoreRoundBf16{s.k2, E});
  dense<8, 2>(mem, E, S, E, w.wcv, E, w.bcv, StoreRoundBf16{s.v2, E});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const int o = h * D;
    head_probs<D>(s.q2 + o, E, s.k2 + o, E, T, S, P);
    head_out<D>(P, T, S, s.v2 + o, E, sv + c.om2 + o, W);
  }
  dense<5, 2>(sv + c.om2, W, T, E, w.wco, E, w.bco, AddStore{s.x2, s.x3, E});
  __syncthreads();
  // MLP
  ln_rows(s.x3, T, E, w.g3, w.be3, sv + c.n3, W, s.xh3, s.r3);
  dense<5, 2>(sv + c.n3, W, T, E, w.w1, FF, w.b1, GeluStore<>{s.z, FF, sv + c.hg, W});
  __syncthreads();
  dense<5, 2>(sv + c.hg, W, T, FF, w.w2, E, w.b2, AddStore{s.x3, y32, E});
  __syncthreads();
}

// The layer's backward for one robot after dec_fwd: s.g holds dL/dy on
// entry and dL/dx on exit; dmem (S, E) bf16 is written; `sm` is this
// robot's (S, 2E) dk2c | dv2c rows; vp its bias / LN partials (g1 0, be1 E,
// bqkv 2E, bso 5E, g2 6E, be2 7E, bcq 8E, bck 9E, bcv 10E, bco 11E, g3 12E,
// be3 13E, b1 14E, b2 14E + FF).
template <int D>
__device__ void dec_bwd(const DecLayer& w, const DecWs& s, bf16* sv, bf16* sm, bf16* dmem,
                        float* P, float* vp, int T, int S, int E, int FF, int H) {
  const DecCols c(E, FF);
  const int W = c.W;
  // MLP
  to_bf16(s.g, E, T, E, sv + c.gc, W);
  colsum(s.g, E, T, E, nullptr, 0, vp + 14 * E + FF);
  __syncthreads();
  dense<5, 2>(sv + c.gc, W, T, E, w.w2_t, FF, nullptr, GeluBwd<>{s.z, s.dz, FF, sv + c.dzc, W});
  __syncthreads();
  colsum(s.dz, FF, T, FF, nullptr, 0, vp + 14 * E);
  dense<5, 2>(sv + c.dzc, W, T, FF, w.w1_t, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh3, E, vp + 12 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 13 * E);
  ln_bwd_rows(s.tmp, s.xh3, s.r3, w.g3, T, E, s.g, s.ga);  // ga = dx3
  to_bf16(s.ga, E, T, E, sv + c.da2, W);
  colsum(s.ga, E, T, E, nullptr, 0, vp + 11 * E);
  __syncthreads();
  // cross-attention
  dense<5, 2>(sv + c.da2, W, T, E, w.wco_t, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const int o = h * D;
    head_probs<D>(s.q2 + o, E, s.k2 + o, E, T, S, P);
    head_bwd<D>(P, T, S, s.q2 + o, E, s.k2 + o, E, s.v2 + o, E, s.dom + o, E, sv + c.dq2c + o, W,
                sm + o, 2 * E, sm + E + o, 2 * E, s.dk32 + o, s.dv32 + o, E);
  }
  colsum(sv + c.dq2c, W, T, E, nullptr, 0, vp + 8 * E);
  colsum(s.dk32, E, S, E, nullptr, 0, vp + 9 * E);
  colsum(s.dv32, E, S, E, nullptr, 0, vp + 10 * E);
  // dmem = dk2c wck^T + dv2c wcv^T, rounded once
  dense<8, 2>(sm, 2 * E, S, E, w.wck_t, E, nullptr, StoreF32{s.tmpS, E});
  __syncthreads();
  dense<8, 2>(sm + E, 2 * E, S, E, w.wcv_t, E, nullptr, AddRoundBf16{s.tmpS, E, dmem, E});
  dense<5, 2>(sv + c.dq2c, W, T, E, w.wcq_t, E, nullptr, StoreF32{s.tmp, E});  // dn2
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh2, E, vp + 6 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 7 * E);
  ln_bwd_rows(s.tmp, s.xh2, s.r2, w.g2, T, E, s.ga, s.gb);  // gb = dx2
  to_bf16(s.gb, E, T, E, sv + c.da1, W);
  colsum(s.gb, E, T, E, nullptr, 0, vp + 5 * E);
  __syncthreads();
  // self-attention
  dense<5, 2>(sv + c.da1, W, T, E, w.wso_t, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  bf16* dqkv = sv + c.dqkv;
  for (int h = 0; h < H; ++h) {
    const int o = h * D;
    const bf16* q = s.qkv + o;
    head_probs<D>(q, 3 * E, q + E, 3 * E, T, T, P);
    head_bwd<D>(P, T, T, q, 3 * E, q + E, 3 * E, q + 2 * E, 3 * E, s.dom + o, E, dqkv + o, W,
                dqkv + E + o, W, dqkv + 2 * E + o, W, nullptr, nullptr, 0);
  }
  colsum(dqkv, W, T, 3 * E, nullptr, 0, vp + 2 * E);
  dense<5, 2>(dqkv, W, T, 3 * E, w.wqkv_t, E, nullptr, StoreF32{s.tmp, E});  // dn1
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh1, E, vp);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + E);
  ln_bwd_rows(s.tmp, s.xh1, s.r1, w.g1, T, E, s.gb, s.g);
}

__device__ inline DecWs dec_robot_ws(const DecArgs& a, int b) {
  DecWs s;
  size_t n32, nbf;
  dec_carve(a.T, a.S, a.E, a.FF, a.ws32 + (size_t)b * a.ws32_stride,
            a.wsbf + (size_t)b * a.wsbf_stride, &s, &n32, &nbf);
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads) decoder_layer_fwd_kernel(DecArgs a) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, T = a.T, E = a.E;
  const DecWs s = dec_robot_ws(a, b);
  const size_t te = (size_t)T * E;
  bf16* sv = a.saved + (size_t)b * T * DecCols(E, a.FF).W;
  dec_fwd<D>(dec_weights(a), s, sv, a.x + b * te, a.mem + (size_t)b * a.S * E, s.g, P, T, a.S, E,
          a.FF, a.H);
  bf16* y = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) y[i] = __float2bfloat16(s.g[i]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) decoder_layer_bwd_kernel(DecArgs a) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, T = a.T, S = a.S, E = a.E;
  const DecWs s = dec_robot_ws(a, b);
  const DecLayer w = dec_weights(a);
  const size_t te = (size_t)T * E, se = (size_t)S * E;
  bf16* sv = a.saved + (size_t)b * T * DecCols(E, a.FF).W;
  const bf16* dy = a.dy + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) s.g[i] = tof(dy[i]);
  __syncthreads();
  dec_fwd<D>(w, s, sv, a.x + b * te, a.mem + b * se, s.tmp, P, T, S, E, a.FF, a.H);
  dec_bwd<D>(w, s, sv, a.saved_mem + (size_t)b * S * 2 * E, a.dmem + b * se, P,
          a.vpart + (size_t)b * (15 * E + a.FF), T, S, E, a.FF, a.H);
  bf16* dx = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
}

static int dec_setup(DecArgs& a, const int* ints, size_t* smem) {
  a.B = ints[0];
  a.T = ints[1];
  a.S = ints[2];
  a.E = ints[3];
  a.H = ints[4];
  a.FF = ints[5];
  a.ws32_stride = ints[6];
  a.wsbf_stride = ints[7];
  size_t n32, nbf;
  dec_carve(a.T, a.S, a.E, a.FF, nullptr, nullptr, nullptr, &n32, &nbf);
  if (head_dim(a.E, a.H) == 0 || a.E % 8 || a.FF % 8 || n32 > (size_t)a.ws32_stride ||
      nbf > (size_t)a.wsbf_stride)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)a.T * (a.S > a.T ? a.S : a.T) * sizeof(float);
  return 0;
}

}  // namespace sd

// ptrs: x, mem, 22 weights, y, ws32, wsbf, saved (B*T, 12E+2FF)
// ints: B, T, S, E, H, FF, ws32_stride, wsbf_stride
extern "C" int sd_decoder_layer_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  DecArgs a = {};
  size_t smem;
  if (int err = dec_setup(a, ints, &smem)) return err;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.mem = static_cast<const bf16*>(ptrs[1]);
  for (int i = 0; i < 22; ++i) a.w[i] = static_cast<const bf16*>(ptrs[2 + i]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[24]));
  a.ws32 = static_cast<float*>(const_cast<void*>(ptrs[25]));
  a.wsbf = static_cast<bf16*>(const_cast<void*>(ptrs[26]));
  a.saved = static_cast<bf16*>(const_cast<void*>(ptrs[27]));
  auto kernel =
      head_dim(a.E, a.H) == 32 ? decoder_layer_fwd_kernel<32> : decoder_layer_fwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: x, mem, dy, 22 weights, 8 transposed (wqkv wso wcq wck wcv wco w1 w2), dx, dmem,
//       8 weight-matrix grads (same order as the transposed), gvec (15E+FF),
//       ws32, wsbf, saved, saved_mem (B*S, 2E), vpart (B, 15E+FF), tpart
// ints: B, T, S, E, H, FF, ws32_stride, wsbf_stride, rows_per_split
extern "C" int sd_decoder_layer_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  DecArgs a = {};
  size_t smem;
  if (int err = dec_setup(a, ints, &smem)) return err;
  const int rows_per_split = ints[8];
  auto P = [&](int i) { return const_cast<void*>(ptrs[i]); };
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.mem = static_cast<const bf16*>(ptrs[1]);
  a.dy = static_cast<const bf16*>(ptrs[2]);
  for (int i = 0; i < 22; ++i) a.w[i] = static_cast<const bf16*>(ptrs[3 + i]);
  for (int i = 0; i < 8; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[25 + i]);
  a.out = static_cast<bf16*>(P(33));
  a.dmem = static_cast<bf16*>(P(34));
  float* mats[8];
  for (int i = 0; i < 8; ++i) mats[i] = static_cast<float*>(P(35 + i));
  float* gvec = static_cast<float*>(P(43));
  a.ws32 = static_cast<float*>(P(44));
  a.wsbf = static_cast<bf16*>(P(45));
  a.saved = static_cast<bf16*>(P(46));
  a.saved_mem = static_cast<bf16*>(P(47));
  a.vpart = static_cast<float*>(P(48));
  float* tpart = static_cast<float*>(P(49));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel =
      head_dim(a.E, a.H) == 32 ? decoder_layer_bwd_kernel<32> : decoder_layer_bwd_kernel<64>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int E = a.E, FF = a.FF, RT = a.B * a.T, RS = a.B * a.S;
  const DecCols c(E, FF);
  const bf16 *rows = a.saved, *mrows = a.saved_mem;
  // (A, B, lda, ldb, K, N, R) of dwqkv dwso dwcq dwck dwcv dwco dw1 dw2
  struct Spec { const bf16 *A, *B; int lda, ldb, K, N, R; };
  const Spec spec[8] = {
      {rows + c.n1, rows + c.dqkv, c.W, c.W, E, 3 * E, RT},
      {rows + c.om1, rows + c.da1, c.W, c.W, E, E, RT},
      {rows + c.n2, rows + c.dq2c, c.W, c.W, E, E, RT},
      {a.mem, mrows, E, 2 * E, E, E, RS},
      {a.mem, mrows + E, E, 2 * E, E, E, RS},
      {rows + c.om2, rows + c.da2, c.W, c.W, E, E, RT},
      {rows + c.n3, rows + c.dzc, c.W, c.W, E, FF, RT},
      {rows + c.hg, rows + c.gc, c.W, c.W, FF, E, RT},
  };
  TdotJob jobs[8];
  size_t off = 0;
  for (int j = 0; j < 8; ++j) {
    const Spec& p = spec[j];
    jobs[j] = TdotJob{p.A, p.B, tpart + off, mats[j], p.lda, p.ldb, p.K, p.N, p.R};
    off += (size_t)tdot_splits(p.R, rows_per_split) * p.K * p.N;
  }
  const SumJob vec{a.vpart, gvec, a.B, 15 * E + FF};
  return launch_weight_grads(jobs, 8, &vec, 1, rows_per_split, st);
}
