// Fused cross-attending decoder layer for training: forward (kernel A) and
// hand-written backward with recompute (kernel B), one thread block per
// robot.
//
// Replaces soccerdiffusion_tpu/ops/fused_decoder_layer.py:
// make_decoder_layer_fn (_fwd_impl, _make_fwd_kernel / _decoder_core; and
// _bwd_impl, _make_bwd_kernel).
//
// Bound on the H100: per robot at T=10 chunk rows over S memory rows the
// forward is ~103 MFLOP at E=FF=256 (S=312, head_dim 64; ~25 MFLOP at
// E=FF=128, S=302, head_dim 32), ~80% of it the in-kernel projection of the
// memory's K/V (S x E x 2E); the backward recomputes the forward and adds
// ~2x that (dmem = [dk | dv] [wck | wcv]^T is another S-row product):
// compute-bound at the 989 TFLOP/s bf16 tensor-core peak (0.025 ms forward
// at B=256, head_dim 64). The first port did every product as scalar fp32
// FMAs. Every product now runs on the tensor cores (mma.sync m16n8k16 bf16,
// mma.cuh): the dense products as mma_dense_rows warp items with 16-byte
// loads of A (shared memory in the forward, the workspace in the backward)
// and of B, the weights in L2 with the reduction axis contiguous (the
// transposed copies (out, in) for the forward products, the (in, out)
// originals for the input-gradient products); attention per (head, 16-row
// tile) or split over the keys, with the scores in registers. What bounds
// it now (tools/decoder_phase_clock.py, PERF.md): bytes through L2, not the
// tensor cores. In the forward, half the time is the K/V projection, whose
// 32 x 32 warp items read a head's weights 10 times and the robot's memory
// rows 4 times per head; the 10-row products use 10 of an m16 tile's 16
// rows and read every weight once per robot. In the backward, the S-row
// products (the K/V recompute, dmem) and the cross-attention's passes over
// the workspace at 8 warps per SM. One block per robot: B=64 fills 64 of
// 132 SMs (a robot split over blocks by heads would repeat the 10-row
// products and the self-attention in each). Design:
//   * forward: a robot's fp32 residual and bf16 operands in shared memory
//     (16 warps); the memory's K/V projected and attended head by head: one
//     head's K and V (2 x S x (D + 8) bf16, 90 KB at S=312, D=64) fit where
//     a robot's (2 x S x E, 312 KB) would not, and never go to global
//     memory. With T=10 queries a head is one 16-row q tile, so the
//     cross-attention splits its keys over the warps in 32-key chunks
//     (mma.cuh:attn_fwd_split) instead of leaving one warp at work. Shared
//     memory (dec_fwd_smem_bytes): T E fp32 + T (E + 8) + T (max(3E, FF) + 8) bf16
//     + one head's K/V + the split's partials: 163 KB at head_dim 64 (E=256,
//     S=312, T=10), 86 KB at head_dim 32 (E=128, S=302);
//   * backward (8 warps, up to 255 registers a thread for the attention
//     tiles): the recompute projects every head's K/V at once into the
//     robot's global workspace (L1/L2-resident while the block runs) and
//     keeps every other intermediate there too, as the encoder layer's
//     backward does (encoder_layer.cuh); in shared memory 3 H T floats of
//     softmax statistics and the T rows of q2 | dom, which every (head,
//     16-key tile) item of the cross-attention's dk / dv pass reads;
//   * the weight gradients (dwck / dwcv over B*S memory rows, the others
//     over B*T chunk rows) are `tdot` products of bf16 operands this kernel
//     writes, summed over the batch in a fixed order by weight_grads.cu, as
//     are the per-robot bias / LayerNorm partials (no race, no atomics); the
//     key / value bias gradients sum the unrounded fp32 dk / dv per 16-key
//     tile (the attention tiles' column sums), then over the tiles in order;
//   * no 8-row padding or key-column mask (T rows as they are, masked at the
//     mma tile edges), no lane-masked head stacking, erff for the exact GELU;
//   * forward and backward have instances for head_dim 32 (h128) and 64
//     (the flagship: E=256, 4 heads, S=312 memory rows in training).
#include "encoder_layer.cuh"

namespace sd {

struct DecArgs {
  const bf16* x;    // (B, T, E)
  const bf16* mem;  // (B, S, E)
  const bf16* dy;   // bwd: (B, T, E)
  bf16* out;        // fwd: y; bwd: dx (B, T, E)
  bf16* dmem;       // bwd: (B, S, E)
  // g1 be1 wqkv bqkv wso bso g2 be2 wcq bcq wck bck wcv bcv wco bco g3 be3 w1 b1 w2 b2
  const bf16* w[22];
  // transposed (out, in): wqkv wso wcq wco w1 w2
  const bf16* wt[6];
  // the memory's K/V projection by head: wkv_t (2E, E) rows h 2D .. h 2D + D - 1
  // are wck's output columns of head h (transposed), the next D wcv's; bkv (2E) alike
  const bf16* wkv_t;
  const bf16* bkv;
  const bf16* wkvc;  // bwd: [wck | wcv] (E, 2E), for dmem
  float* ws32;       // bwd: (B, ws32_stride)
  bf16* wsbf;        // bwd: (B, wsbf_stride)
  bf16* saved;       // bwd: (B*T, 12E + 2FF) rows: n1 dqkv om1 da1 n2 dq2c om2 da2 n3 gc dzc hg
  bf16* saved_mem;   // bwd: (B*S, 2E) rows: dk2c dv2c
  float* vpart;      // bwd: (B, 15E + FF)
  int B, T, S, E, H, FF, ws32_stride, wsbf_stride;
};

struct DecWs {  // one robot's backward workspace
  float *x, *x2, *x3, *xh1, *xh2, *xh3, *tmp, *ga, *gb, *g, *z, *dz, *r1, *r2, *r3;
  float *dk32, *dv32;  // (S / 16 tiles, E): fp32 column sums of dk / dv per 16-key tile
  bf16 *qkv, *q2, *dom, *k2, *v2;
};

// 16-key tiles of the cross-attention's dk / dv column sums
__host__ __device__ inline int key_tiles(int S) { return (S + 15) / 16; }

// Carves one robot's workspace (when f / h are given) and returns the fp32
// and bf16 elements it needs (ops/fused_decoder_layer.py:_ws_strides).
__host__ __device__ inline void dec_carve(int T, int S, int E, int FF, float* f, bf16* h,
                                          DecWs* w, size_t* n32, size_t* nbf) {
  const size_t te = r4((size_t)T * E), tf = r4((size_t)T * FF), t = r4(T);
  const size_t ke = r4((size_t)key_tiles(S) * E);
  const size_t te8 = r8((size_t)T * E), se8 = r8((size_t)S * E), q8 = r8((size_t)3 * T * E);
  *n32 = 10 * te + 2 * tf + 3 * t + 2 * ke;
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
  w->dv32 = p + ke;
  w->qkv = h;
  w->q2 = h + q8;
  w->dom = h + q8 + te8;
  w->k2 = h + q8 + 2 * te8;
  w->v2 = h + q8 + 2 * te8 + se8;
}

struct DecLayer {
  const bf16 *g1, *be1, *wqkv, *bqkv, *wso, *bso, *g2, *be2, *wcq, *bcq, *wck, *bck, *wcv, *bcv,
      *wco, *bco, *g3, *be3, *w1, *b1, *w2, *b2;
  const bf16 *wqkv_t, *wso_t, *wcq_t, *wco_t, *w1_t, *w2_t;
};

static_assert(sizeof(DecLayer) == 28 * sizeof(const bf16*), "DecLayer is 28 pointers");

__device__ inline DecLayer dec_weights(const DecArgs& a) {
  DecLayer w;
  const bf16** p = &w.g1;  // the 22 weights, then the 6 transposed ones, in order
  for (int i = 0; i < 22; ++i) p[i] = a.w[i];
  for (int i = 0; i < 6; ++i) p[22 + i] = a.wt[i];
  return w;
}

// Column offsets in a saved chunk row
struct DecCols {
  int n1, dqkv, om1, da1, n2, dq2c, om2, da2, n3, gc, dzc, hg, W;
  __host__ __device__ DecCols(int E, int FF)
      : n1(0), dqkv(E), om1(4 * E), da1(5 * E), n2(6 * E), dq2c(7 * E), om2(8 * E), da2(9 * E),
        n3(10 * E), gc(11 * E), dzc(12 * E), hg(12 * E + FF), W(12 * E + 2 * FF) {}
};

// Column n of a [K | V] projection by head (wkv_t's order): bf16 k or v[m][h D + d]
struct KVStore {
  bf16* k;
  bf16* v;
  int ld, D;
  __device__ void operator()(int m, int n, float x) const {
    const int h = n / (2 * D), r = n % (2 * D);
    bf16* dst = r < D ? k : v;
    dst[m * ld + h * D + (r < D ? r : r - D)] = __float2bfloat16(x);
  }
};

// The forward kernel's shared memory: x (T, E) fp32, the split attention's
// partials, act (T, E + 8), wide (T, max(3E, FF) + 8), one head's K and V
// (S, D + 8 each), bf16; rows padded by 8 elements for ldmatrix
__host__ __device__ inline int dec_wide(int E, int FF) { return (3 * E > FF ? 3 * E : FF) + 8; }
__host__ __device__ inline size_t dec_fwd_smem_bytes(int T, int S, int E, int FF, int D) {
  return sizeof(float) * ((size_t)T * E + split_red_floats(D, S, kFwdThreads / 32)) +
         sizeof(bf16) * ((size_t)T * (E + 8) + (size_t)T * dec_wide(E, FF) + 2 * (size_t)S * (D + 8));
}

// The layer's forward for one robot with every operand in shared memory
// (the forward kernel): x (T, E) bf16 and mem (S, E) bf16 -> y (T, E) bf16.
template <int D>
__device__ void dec_fwd_smem(const DecLayer& w, const DecArgs& a, const bf16* xin,
                             const bf16* mem, bf16* y) {
  extern __shared__ float4 smem4[];
  const int T = a.T, S = a.S, E = a.E, FF = a.FF, H = a.H;
  const int lda = E + 8, ldw = dec_wide(E, FF), ldk = D + 8;
  float* x = reinterpret_cast<float*>(smem4);
  float* red = x + T * E;
  bf16* act = reinterpret_cast<bf16*>(red + split_red_floats(D, S, blockDim.x >> 5));
  bf16* wide = act + T * lda;
  bf16* ks = wide + T * ldw;
  bf16* vs = ks + S * ldk;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) x[i] = tof(xin[i]);
  __syncthreads();
  // self-attention
  ln_bf16_rows(x, T, E, w.g1, w.be1, act, lda);
  __syncthreads();
  mma_dense_rows<1, 2>(act, lda, T, E, w.wqkv_t, E, 3 * E, w.bqkv, StoreRoundBf16{wide, ldw});
  __syncthreads();
  attention_fwd<D, true>(wide, ldw, T, E, H, act, lda);
  __syncthreads();
  mma_dense_rows<1, 2>(act, lda, T, E, w.wso_t, E, E, w.bso, AddTo{x, E});
  __syncthreads();
  // cross-attention: q2 in wide; one head's memory K / V at a time
  ln_bf16_rows(x, T, E, w.g2, w.be2, act, lda);
  __syncthreads();
  mma_dense_rows<1, 2>(act, lda, T, E, w.wcq_t, E, E, w.bcq, StoreRoundBf16{wide, ldw});
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    mma_dense_rows<2, 4>(mem, E, S, E, a.wkv_t + (size_t)h * 2 * D * E, E, 2 * D,
                         a.bkv + h * 2 * D, KVStore{ks, vs, ldk, D});
    __syncthreads();
    attn_fwd_split<D>(wide + h * D, ldw, T, ks, vs, ldk, S, act + h * D, lda, red);
  }
  mma_dense_rows<1, 2>(act, lda, T, E, w.wco_t, E, E, w.bco, AddTo{x, E});
  __syncthreads();
  // MLP
  ln_bf16_rows(x, T, E, w.g3, w.be3, act, lda);
  __syncthreads();
  mma_dense_rows<1, 2>(act, lda, T, E, w.w1_t, E, FF, w.b1, GeluBf16<kGeluExact>{wide, ldw});
  __syncthreads();
  mma_dense_rows<1, 2>(wide, ldw, T, FF, w.w2_t, FF, E, w.b2, AddTo{x, E});
  __syncthreads();
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) y[i] = __float2bfloat16(x[i]);
}

// The backward's recompute of the forward for one robot: every
// intermediate the backward needs into the saved row and the workspace
// (the layer's output itself is not needed).
template <int D>
__device__ void dec_fwd_ws(const DecLayer& w, const DecArgs& a, const DecWs& s, bf16* sv,
                           const bf16* x, const bf16* mem) {
  const int T = a.T, S = a.S, E = a.E, FF = a.FF, H = a.H;
  const DecCols c(E, FF);
  const int W = c.W;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) s.x[i] = tof(x[i]);
  __syncthreads();
  // self-attention
  ln_rows(s.x, T, E, w.g1, w.be1, sv + c.n1, W, s.xh1, s.r1);
  mma_dense_rows<1, 2>(sv + c.n1, W, T, E, w.wqkv_t, E, 3 * E, w.bqkv,
                          StoreRoundBf16{s.qkv, 3 * E});
  __syncthreads();
  attention_fwd<D>(s.qkv, 3 * E, T, E, H, sv + c.om1, W);
  __syncthreads();
  mma_dense_rows<1, 2>(sv + c.om1, W, T, E, w.wso_t, E, E, w.bso, AddStore{s.x, s.x2, E});
  __syncthreads();
  // cross-attention with the memory's K / V projected here, every head at once
  ln_rows(s.x2, T, E, w.g2, w.be2, sv + c.n2, W, s.xh2, s.r2);
  mma_dense_rows<1, 2>(sv + c.n2, W, T, E, w.wcq_t, E, E, w.bcq, StoreRoundBf16{s.q2, E});
  mma_dense_rows<2, 4>(mem, E, S, E, a.wkv_t, E, 2 * E, a.bkv, KVStore{s.k2, s.v2, E, D});
  __syncthreads();
  attention_fwd<D>(s.q2, E, T, s.k2, s.v2, E, S, H, sv + c.om2, W);
  __syncthreads();
  mma_dense_rows<1, 2>(sv + c.om2, W, T, E, w.wco_t, E, E, w.bco, AddStore{s.x2, s.x3, E});
  __syncthreads();
  // MLP
  ln_rows(s.x3, T, E, w.g3, w.be3, sv + c.n3, W, s.xh3, s.r3);
  mma_dense_rows<1, 2>(sv + c.n3, W, T, E, w.w1_t, E, FF, w.b1,
                       GeluStore<>{s.z, FF, sv + c.hg, W});
  __syncthreads();
}

// The layer's backward for one robot after dec_fwd_ws: s.g holds dL/dy on
// entry and dL/dx on exit; dmem (S, E) bf16 is written; `sm` is this
// robot's (S, 2E) dk2c | dv2c rows; vp its bias / LN partials (g1 0, be1 E,
// bqkv 2E, bso 5E, g2 6E, be2 7E, bcq 8E, bck 9E, bcv 10E, bco 11E, g3 12E,
// be3 13E, b1 14E, b2 14E + FF); stats: 3 H T floats and qd: T (2E + 8) bf16
// of shared memory.
template <int D>
__device__ void dec_bwd(const DecLayer& w, const DecArgs& a, const DecWs& s, bf16* sv, bf16* sm,
                        bf16* dmem, float* stats, bf16* qd, float* vp) {
  const int T = a.T, S = a.S, E = a.E, FF = a.FF, H = a.H;
  const DecCols c(E, FF);
  const int W = c.W;
  // MLP: dhg = g w2^T; dz = dhg GELU'(z); dn3 = dz w1^T
  to_bf16(s.g, E, T, E, sv + c.gc, W);
  colsum(s.g, E, T, E, nullptr, 0, vp + 14 * E + FF);
  __syncthreads();
  mma_dense_rows<1, 2>(sv + c.gc, W, T, E, w.w2, E, FF, nullptr,
                       GeluBwd<>{s.z, s.dz, FF, sv + c.dzc, W});
  __syncthreads();
  colsum(s.dz, FF, T, FF, nullptr, 0, vp + 14 * E);
  mma_dense_rows<1, 2>(sv + c.dzc, W, T, FF, w.w1, FF, E, nullptr, StoreF32{s.tmp, E});
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh3, E, vp + 12 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 13 * E);
  ln_bwd_rows(s.tmp, s.xh3, s.r3, w.g3, T, E, s.g, s.ga);  // ga = dx3
  to_bf16(s.ga, E, T, E, sv + c.da2, W);
  colsum(s.ga, E, T, E, nullptr, 0, vp + 11 * E);
  __syncthreads();
  // cross-attention: dom = da2 wco^T, then every head over the S memory rows
  mma_dense_rows<1, 2>(sv + c.da2, W, T, E, w.wco, E, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  // q2 | dom into shared memory (qd, rows of 2E + 8): every key tile of the
  // second pass reads all T of them
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) {
    const int t = i / E, e = i % E;
    qd[t * (2 * E + 8) + e] = s.q2[i];
    qd[t * (2 * E + 8) + E + e] = s.dom[i];
  }
  attention_bwd_dq<D>(s.q2, E, T, s.k2, s.v2, E, S, s.dom, E, H, sv + c.dq2c, W, stats);
  attention_bwd_dkv<D, true, true>(qd, 2 * E + 8, T, s.k2, s.v2, E, S, qd + E, 2 * E + 8, H, sm,
                                   sm + E, 2 * E, stats, s.dk32, s.dv32, E);
  colsum(sv + c.dq2c, W, T, E, nullptr, 0, vp + 8 * E);
  colsum(s.dk32, E, key_tiles(S), E, nullptr, 0, vp + 9 * E);
  colsum(s.dv32, E, key_tiles(S), E, nullptr, 0, vp + 10 * E);
  // dmem = dk2c wck^T + dv2c wcv^T = [dk2c | dv2c] [wck | wcv]^T, rounded once
  mma_dense_rows<2, 4>(sm, 2 * E, S, 2 * E, a.wkvc, 2 * E, E, nullptr, StoreRoundBf16{dmem, E});
  mma_dense_rows<1, 2>(sv + c.dq2c, W, T, E, w.wcq, E, E, nullptr, StoreF32{s.tmp, E});  // dn2
  __syncthreads();
  colsum(s.tmp, E, T, E, s.xh2, E, vp + 6 * E);
  colsum(s.tmp, E, T, E, nullptr, 0, vp + 7 * E);
  ln_bwd_rows(s.tmp, s.xh2, s.r2, w.g2, T, E, s.ga, s.gb);  // gb = dx2
  to_bf16(s.gb, E, T, E, sv + c.da1, W);
  colsum(s.gb, E, T, E, nullptr, 0, vp + 5 * E);
  __syncthreads();
  // self-attention
  mma_dense_rows<1, 2>(sv + c.da1, W, T, E, w.wso, E, E, nullptr, StoreRoundBf16{s.dom, E});
  __syncthreads();
  bf16* dqkv = sv + c.dqkv;
  attention_bwd<D>(s.qkv, 3 * E, s.dom, E, T, E, H, dqkv, W, stats);
  colsum(dqkv, W, T, 3 * E, nullptr, 0, vp + 2 * E);
  mma_dense_rows<1, 2>(dqkv, W, T, 3 * E, w.wqkv, 3 * E, E, nullptr, StoreF32{s.tmp, E});  // dn1
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
__global__ void __launch_bounds__(kFwdThreads) decoder_layer_fwd_kernel(DecArgs a) {
  const int b = blockIdx.x;
  const size_t te = (size_t)a.T * a.E;
  dec_fwd_smem<D>(dec_weights(a), a, a.x + b * te, a.mem + (size_t)b * a.S * a.E, a.out + b * te);
}

template <int D>
__global__ void __launch_bounds__(kThreads) decoder_layer_bwd_kernel(DecArgs a) {
  extern __shared__ float4 smem4[];
  float* stats = reinterpret_cast<float*>(smem4);
  bf16* qd = reinterpret_cast<bf16*>(smem4 + (3 * a.H * a.T + 3) / 4);
  const int b = blockIdx.x, T = a.T, S = a.S, E = a.E;
  const DecWs s = dec_robot_ws(a, b);
  const DecLayer w = dec_weights(a);
  const size_t te = (size_t)T * E, se = (size_t)S * E;
  bf16* sv = a.saved + (size_t)b * T * DecCols(E, a.FF).W;
  const bf16* dy = a.dy + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) s.g[i] = tof(dy[i]);
  __syncthreads();
  dec_fwd_ws<D>(w, a, s, sv, a.x + b * te, a.mem + b * se);
  dec_bwd<D>(w, a, s, sv, a.saved_mem + (size_t)b * S * 2 * E, a.dmem + b * se, stats, qd,
             a.vpart + (size_t)b * (15 * E + a.FF));
  bf16* dx = a.out + b * te;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
}

// The argument checks (head_dim 32 or 64, widths multiples of 8; bwd: the
// workspace strides); returns the kernel's shared memory.
static int dec_setup(DecArgs& a, const int* ints, bool bwd, size_t* smem) {
  a.B = ints[0];
  a.T = ints[1];
  a.S = ints[2];
  a.E = ints[3];
  a.H = ints[4];
  a.FF = ints[5];
  const int D = head_dim(a.E, a.H);
  if (D == 0 || a.E % 8 || a.FF % 8 || a.T < 1 || a.S < 1) return (int)cudaErrorInvalidValue;
  if (bwd) {
    a.ws32_stride = ints[6];
    a.wsbf_stride = ints[7];
    size_t n32, nbf;
    dec_carve(a.T, a.S, a.E, a.FF, nullptr, nullptr, nullptr, &n32, &nbf);
    if (n32 > (size_t)a.ws32_stride || nbf > (size_t)a.wsbf_stride || a.ws32_stride % 4 ||
        a.wsbf_stride % 8)
      return (int)cudaErrorInvalidValue;
    *smem = 16 * (size_t)((3 * a.H * a.T + 3) / 4) + 2 * (size_t)a.T * (2 * a.E + 8);
  } else {
    *smem = dec_fwd_smem_bytes(a.T, a.S, a.E, a.FF, D);
  }
  return *smem > 232448 ? (int)cudaErrorInvalidValue : 0;
}

template <class Kernel>
static int dec_launch(Kernel kernel, int threads, size_t smem, const DecArgs& a, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace sd

// ptrs: x, mem, 22 weights, 6 transposed (wqkv wso wcq wco w1 w2), wkv_t (2E, E), bkv (2E), y
// ints: B, T, S, E, H, FF
extern "C" int sd_decoder_layer_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  DecArgs a = {};
  size_t smem;
  if (int err = dec_setup(a, ints, false, &smem)) return err;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.mem = static_cast<const bf16*>(ptrs[1]);
  for (int i = 0; i < 22; ++i) a.w[i] = static_cast<const bf16*>(ptrs[2 + i]);
  for (int i = 0; i < 6; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[24 + i]);
  a.wkv_t = static_cast<const bf16*>(ptrs[30]);
  a.bkv = static_cast<const bf16*>(ptrs[31]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[32]));
  auto kernel =
      head_dim(a.E, a.H) == 32 ? decoder_layer_fwd_kernel<32> : decoder_layer_fwd_kernel<64>;
  return dec_launch(kernel, kFwdThreads, smem, a, static_cast<cudaStream_t>(stream));
}

// ptrs: x, mem, dy, 22 weights, 6 transposed (wqkv wso wcq wco w1 w2), wkv_t, bkv,
//       wkvc (E, 2E), dx, dmem, 8 weight-matrix grads (wqkv wso wcq wck wcv wco w1 w2),
//       gvec (15E+FF), ws32, wsbf, saved, saved_mem (B*S, 2E), vpart (B, 15E+FF), tpart
// ints: B, T, S, E, H, FF, ws32_stride, wsbf_stride, rows_per_split
extern "C" int sd_decoder_layer_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  DecArgs a = {};
  size_t smem;
  if (int err = dec_setup(a, ints, true, &smem)) return err;
  const int rows_per_split = ints[8];
  auto P = [&](int i) { return const_cast<void*>(ptrs[i]); };
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.mem = static_cast<const bf16*>(ptrs[1]);
  a.dy = static_cast<const bf16*>(ptrs[2]);
  for (int i = 0; i < 22; ++i) a.w[i] = static_cast<const bf16*>(ptrs[3 + i]);
  for (int i = 0; i < 6; ++i) a.wt[i] = static_cast<const bf16*>(ptrs[25 + i]);
  a.wkv_t = static_cast<const bf16*>(ptrs[31]);
  a.bkv = static_cast<const bf16*>(ptrs[32]);
  a.wkvc = static_cast<const bf16*>(ptrs[33]);
  a.out = static_cast<bf16*>(P(34));
  a.dmem = static_cast<bf16*>(P(35));
  float* mats[8];
  for (int i = 0; i < 8; ++i) mats[i] = static_cast<float*>(P(36 + i));
  float* gvec = static_cast<float*>(P(44));
  a.ws32 = static_cast<float*>(P(45));
  a.wsbf = static_cast<bf16*>(P(46));
  a.saved = static_cast<bf16*>(P(47));
  a.saved_mem = static_cast<bf16*>(P(48));
  a.vpart = static_cast<float*>(P(49));
  float* tpart = static_cast<float*>(P(50));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel =
      head_dim(a.E, a.H) == 32 ? decoder_layer_bwd_kernel<32> : decoder_layer_bwd_kernel<64>;
  if (int err = dec_launch(kernel, kThreads, smem, a, st)) return err;

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
