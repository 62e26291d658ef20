// Flash attention: softmax(q k^T / sqrt(D)) v over (B, T, H, D) tensors,
// forward and backward (fp32 or bf16 operands, fp32 arithmetic).
//
// Replaces soccerdiffusion_tpu/ops/flash_attention.py: flash_attention
// (_flash_attention_fwd_impl with _attn_kernel and _attn_kernel_streamed;
// _flash_attention_bwd_impl with _attn_bwd_kernel and
// _attn_bwd_kernel_streamed).
//
// Numerics, as the TPU kernel's: fp32 scores times the scale, an fp32
// softmax whose probabilities are NOT rounded, fp32 value sums, the division
// by the denominator after the value product, the output in the operands'
// dtype. The backward recomputes the probabilities from q, k and the row
// log-sum-exp that the forward saves (the TPU kernel recomputes them from
// q, k, v) and uses delta = rowsum(do * o) in fp32 with the saved o.
//
// Bound on the H100: the forward does 4 B H Tq Tk D FLOP against reading
// q, k, v and writing o once, Tq Tk / (Tq + Tk) FLOP per bf16 byte (5-50
// at the model's shapes, T <= 312): bytes-bound at the card's peak rates.
// The backward's 7 products (the scores and do v^T recomputed in each of
// its two kernels) are 3.5x the forward's. Two routes by dtype:
//   * bf16 operands (every shipped path: the models compute in bf16) run
//     on the tensor cores (mma.sync m16n8k16, mma.cuh). A warp owns 16 q
//     rows (16 key rows in dkdv) of one head, with its scores in registers
//     and the online-softmax recursion; a block holds 1-4 such warps of one
//     head (as many as its rows fill, so Tq = 10 wastes 6 rows of 16, not
//     54 of 64), which share the k / v (dkdv: q / do) tiles that it streams
//     through shared memory in 64-row tiles, double-buffered with cp.async.
//     The probabilities (and ds) stay fp32: each P product is two bf16
//     products, hi = bf16(P) and lo = bf16(P - hi) (mma.cuh:pv_step). What
//     bounds it then: the small per-head work (one 16-row q tile at Tq <= 16
//     per block, the exps of the online softmax in the forward, four
//     products per score in the backward) and latency at 1-4 warps a block;
//   * fp32 operands keep the first port's scalar kernels: fp32 FMAs from
//     shared-memory tiles (4 x 4 register blocking per thread, 64-row tiles
//     of 256 threads), bound by fp32 instruction throughput. Design of both:
//   * the TPU wrapper's constructs are not carried over: no padding of D to
//     128 lanes or of T to sublanes in device memory, no (B*H, T, D)
//     fold / transpose copies (the kernels read and write the (B, T, H, D)
//     tensors in place through their (b, t, h) strides), and no split
//     between a single-tile and a streamed variant (which exists because of
//     VMEM's size): the forward streams key tiles with the online-softmax
//     recursion at every Tk;
//   * the head dimension is a template parameter DP in {32, 64, 128}; a
//     head_dim D <= DP is read with the lanes d >= D as zeros and written
//     only below D (any D from 1 to 128); the tensor-core copies are 16-byte
//     cp.async where D, the strides and the pointers are 8-element aligned
//     (vec), element loads otherwise;
//   * scalar forward: one block per (b*h, 64-row q tile), q in shared
//     memory for the whole loop, the k tile transposed and the v tile
//     natural in shared memory, the (64 x 64) probability tile written
//     back to shared memory for the value product; both routes write o and
//     the fp32 row log-sum-exp;
//   * backward: deterministic, without atomics, in two kernels (as
//     weight_grads.cu does for the weight gradients): dq_kernel, over q
//     rows, loops over the k tiles and also writes delta; dkdv_kernel, over
//     key rows, loops over q tiles. Both recompute p = exp(s * scale - lse);
//     every output element is one thread's sum in a fixed order.
#include <type_traits>

#include "mma.cuh"

namespace sd {

constexpr int kFaThreads = 256;  // a 16 x 16 grid: thread (ty, tx) owns rows 4 ty .. 4 ty + 3
constexpr int kFaRows = 64;      // rows of every output tile (q rows, or key rows in dkdv)
constexpr int kFaKeys = 64;      // keys per tile of the forward / dq loops
constexpr int kFaQ = 32;         // q rows per step of the dkdv loop
constexpr int kPld = kFaKeys + 4;  // row stride of the (64 x 64) p / ds tiles
constexpr int kPtld = kFaQ + 4;    // row stride of the (64 x 32) transposed p / ds tiles

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // bwd: the forward's output
  const void* dout;  // bwd: do
  void* out;         // fwd: o
  float* lse;        // (B*H, Tq) fp32 row log-sum-exp (fwd writes, bwd reads)
  float* delta;      // bwd: (B*H, Tq) rowsum(do * o), written by dq_kernel
  void* dq;
  void* dk;
  void* dv;
  int B, H, Tq, Tk, D;
  int s[8][3];  // (b, t, h) element strides of q k v o do dq dk dv
  float scale;
  int vec;  // bf16: 16-byte copies (setup)
};

enum { kQ, kK, kV, kO, kDo, kDq, kDk, kDv };

template <class T>
__device__ __forceinline__ const T* head(const void* p, const int* s, int b, int h) {
  return static_cast<const T*>(p) + (size_t)b * s[0] + (size_t)h * s[2];
}
template <class T>
__device__ __forceinline__ T* head_out(void* p, const int* s, int b, int h) {
  return static_cast<T*>(p) + (size_t)b * s[0] + (size_t)h * s[2];
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// X[r][d] = row r0 + r, element d, as fp32 (r < R, d < DP; zero at or past
// `rows` or D). Threads take consecutive d: coalesced reads of a row.
template <int DP, class T>
__device__ void load_rows(float* X, int ld, const T* base, int row_stride, int r0, int R, int rows,
                          int D) {
  for (int e = threadIdx.x; e < R * DP; e += blockDim.x) {
    const int r = e / DP, d = e % DP;
    X[r * ld + d] = (r0 + r < rows && d < D) ? tof(base[(size_t)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// Xt[d][r]: the same rows transposed. Threads take consecutive rows, so the
// shared-memory stores of a warp are conflict-free.
template <int DP, class T>
__device__ void load_rows_t(float* Xt, int ld, const T* base, int row_stride, int r0, int R,
                            int rows, int D) {
  for (int e = threadIdx.x; e < R * DP; e += blockDim.x) {
    const int r = e % R, d = e / R;
    Xt[d * ld + r] = (r0 + r < rows && d < D) ? tof(base[(size_t)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// The column of element j of a thread's part of an N-wide tile: pairs
// (N = 32) or groups of 4 in 64-column bands, so that the 16 threads of a
// row read consecutive 8 / 16-byte words of a B row.
template <int N>
__device__ __forceinline__ int tile_col(int tx, int j) {
  static_assert(N == 32 || N == 64 || N == 128, "tile widths 32, 64, 128");
  return N == 32 ? 2 * tx + j : (j / 4) * 64 + 4 * tx + (j % 4);
}

// acc[i][j] += sum_{k < K} A[4 ty + i][k] * B[k][tile_col<N>(tx, j)]: A and B
// fp32 row-major in shared memory (lda, ldb multiples of 4), K a multiple
// of 4. A's rows are read as float4 along k (a broadcast to the 16 threads
// of a row), B's as float2 / float4 along n.
template <int N>
__device__ __forceinline__ void mm(float (&acc)[4][N / 16], const float* A, int lda,
                                   const float* B, int ldb, int K) {
  constexpr int NT = N / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 r = *reinterpret_cast<const float4*>(A + (4 * ty + i) * lda + k);
      a[i][0] = r.x;
      a[i][1] = r.y;
      a[i][2] = r.z;
      a[i][3] = r.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* br = B + (k + kk) * ldb;
      float bv[NT];
      if constexpr (NT == 2) {
        const float2 r = *reinterpret_cast<const float2*>(br + 2 * tx);
        bv[0] = r.x;
        bv[1] = r.y;
      } else {
#pragma unroll
        for (int g = 0; g < NT / 4; ++g) {
          const float4 r = *reinterpret_cast<const float4*>(br + 64 * g + 4 * tx);
          bv[4 * g] = r.x;
          bv[4 * g + 1] = r.y;
          bv[4 * g + 2] = r.z;
          bv[4 * g + 3] = r.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] += a[i][kk] * bv[j];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// max / sum over the 16 threads (tx) of a row: lanes 0-15 and 16-31 of a warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of each kernel, in floats.
template <int DP>
constexpr size_t fwd_smem() {  // Q [64][DP], Kt [DP][64], V [64][DP], P [64][kPld]
  return 3 * kFaRows * DP + kFaRows * kPld;
}
template <int DP>
constexpr size_t dq_smem() {  // Q, dO [64][DP], Kt, Vt [DP][64], K [64][DP], dS [64][kPld], lse, delta
  return 5 * kFaRows * DP + kFaRows * kPld + 2 * kFaRows;
}
template <int DP>
constexpr size_t dkdv_smem() {  // K, V [64][DP], Q, dO [32][DP], Qt, dOt [DP][32], Pt, dSt [64][kPtld], lse, delta
  return 2 * kFaRows * DP + 4 * kFaQ * DP + 2 * kFaRows * kPtld + 2 * kFaQ;
}

template <int DP, class T>
__device__ void fwd_scalar(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  float* Q = reinterpret_cast<float*>(smem4);
  float* Kt = Q + kFaRows * DP;
  float* V = Kt + DP * kFaKeys;
  float* P = V + kFaKeys * DP;
  constexpr int NT = DP / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, q0 = blockIdx.y * kFaRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = head<T>(a.k, a.s[kK], b, h);
  const T* vb = head<T>(a.v, a.s[kV], b, h);
  load_rows<DP>(Q, DP, head<T>(a.q, a.s[kQ], b, h), a.s[kQ][1], q0, kFaRows, a.Tq, a.D);
  float m[4], l[4], acc[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);
  for (int k0 = 0; k0 < a.Tk; k0 += kFaKeys) {
    __syncthreads();  // the previous tile's Kt, V and P are consumed
    load_rows_t<DP>(Kt, kFaKeys, kb, a.s[kK][1], k0, kFaKeys, a.Tk, a.D);
    load_rows<DP>(V, DP, vb, a.s[kV][1], k0, kFaKeys, a.Tk, a.D);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm<64>(s, Q, DP, Kt, kFaKeys, DP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + 4 * tx + j < a.Tk ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // finite: key k0 < Tk is in every tile
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mn);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(P + (4 * ty + i) * kPld + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    mm<DP>(acc, P, kPld, V, DP, kFaKeys);
  }
  T* ob = head_out<T>(a.out, a.s[kO], b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = tile_col<DP>(tx, j);
      if (d < a.D) put(ob + (size_t)row * a.s[kO][1] + d, acc[i][j] / l[i]);
    }
    if (tx == 0) a.lse[(size_t)bh * a.Tq + row] = m[i] + logf(l[i]);
  }
}

template <int DP, class T>
__device__ void dq_scalar(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  float* Q = reinterpret_cast<float*>(smem4);
  float* dO = Q + kFaRows * DP;
  float* Kt = dO + kFaRows * DP;
  float* Vt = Kt + DP * kFaKeys;
  float* K = Vt + DP * kFaKeys;
  float* dS = K + kFaKeys * DP;
  float* lse_s = dS + kFaRows * kPld;
  float* delta_s = lse_s + kFaRows;
  constexpr int NT = DP / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, q0 = blockIdx.y * kFaRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kb = head<T>(a.k, a.s[kK], b, h);
  const T* vb = head<T>(a.v, a.s[kV], b, h);
  const T* ob = head<T>(a.o, a.s[kO], b, h);
  load_rows<DP>(Q, DP, head<T>(a.q, a.s[kQ], b, h), a.s[kQ][1], q0, kFaRows, a.Tq, a.D);
  load_rows<DP>(dO, DP, head<T>(a.dout, a.s[kDo], b, h), a.s[kDo][1], q0, kFaRows, a.Tq, a.D);
  __syncthreads();
  // delta = rowsum(do * o) in fp32, one warp per row; saved for dkdv_kernel
  for (int r = warp; r < kFaRows; r += kFaThreads / 32) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < a.Tq)
      for (int d = lane; d < a.D; d += 32) sum += dO[r * DP + d] * tof(ob[(size_t)row * a.s[kO][1] + d]);
    sum = warp_sum(sum);
    if (lane == 0) {
      delta_s[r] = sum;
      lse_s[r] = row < a.Tq ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
      if (row < a.Tq) a.delta[(size_t)bh * a.Tq + row] = sum;
    }
  }
  float acc[4][NT];
  zero(acc);
  for (int k0 = 0; k0 < a.Tk; k0 += kFaKeys) {
    __syncthreads();  // delta / lse written; the previous tile's Kt, Vt, K and dS consumed
    load_rows_t<DP>(Kt, kFaKeys, kb, a.s[kK][1], k0, kFaKeys, a.Tk, a.D);
    load_rows_t<DP>(Vt, kFaKeys, vb, a.s[kV][1], k0, kFaKeys, a.Tk, a.D);
    load_rows<DP>(K, DP, kb, a.s[kK][1], k0, kFaKeys, a.Tk, a.D);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm<64>(s, Q, DP, Kt, kFaKeys, DP);
    mm<64>(dp, dO, DP, Vt, kFaKeys, DP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = k0 + 4 * tx + j < a.Tk && q0 + r < a.Tq;
        const float p = live ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        ds[j] = p * (dp[i][j] - delta_s[r]) * a.scale;
      }
      *reinterpret_cast<float4*>(dS + r * kPld + 4 * tx) = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm<DP>(acc, dS, kPld, K, DP, kFaKeys);
  }
  T* dqb = head_out<T>(a.dq, a.s[kDq], b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = tile_col<DP>(tx, j);
      if (d < a.D) put(dqb + (size_t)row * a.s[kDq][1] + d, acc[i][j]);
    }
  }
}

template <int DP, class T>
__device__ void dkdv_scalar(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  float* K = reinterpret_cast<float*>(smem4);
  float* V = K + kFaRows * DP;
  float* Q = V + kFaRows * DP;
  float* dO = Q + kFaQ * DP;
  float* Qt = dO + kFaQ * DP;
  float* dOt = Qt + DP * kFaQ;
  float* Pt = dOt + DP * kFaQ;
  float* dSt = Pt + kFaRows * kPtld;
  float* lse_s = dSt + kFaRows * kPtld;
  float* delta_s = lse_s + kFaQ;
  constexpr int NT = DP / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, k0 = blockIdx.y * kFaRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = head<T>(a.q, a.s[kQ], b, h);
  const T* dob = head<T>(a.dout, a.s[kDo], b, h);
  load_rows<DP>(K, DP, head<T>(a.k, a.s[kK], b, h), a.s[kK][1], k0, kFaRows, a.Tk, a.D);
  load_rows<DP>(V, DP, head<T>(a.v, a.s[kV], b, h), a.s[kV][1], k0, kFaRows, a.Tk, a.D);
  float dk[4][NT], dv[4][NT];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.Tq; q0 += kFaQ) {
    __syncthreads();  // the previous step's tiles consumed
    load_rows<DP>(Q, DP, qb, a.s[kQ][1], q0, kFaQ, a.Tq, a.D);
    load_rows_t<DP>(Qt, kFaQ, qb, a.s[kQ][1], q0, kFaQ, a.Tq, a.D);
    load_rows<DP>(dO, DP, dob, a.s[kDo][1], q0, kFaQ, a.Tq, a.D);
    load_rows_t<DP>(dOt, kFaQ, dob, a.s[kDo][1], q0, kFaQ, a.Tq, a.D);
    if (threadIdx.x < kFaQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < a.Tq ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
      delta_s[threadIdx.x] = row < a.Tq ? a.delta[(size_t)bh * a.Tq + row] : 0.f;
    }
    __syncthreads();
    // the transposed scores and do v^T of the tile: rows are keys, columns q rows
    float st[4][2], dpt[4][2];
    zero(st);
    zero(dpt);
    mm<32>(st, K, DP, Qt, kFaQ, DP);
    mm<32>(dpt, V, DP, dOt, kFaQ, DP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float p[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 2 * tx + j;
        const bool live = k0 + r < a.Tk && q0 + c < a.Tq;
        p[j] = live ? expf(st[i][j] * a.scale - lse_s[c]) : 0.f;
        ds[j] = p[j] * (dpt[i][j] - delta_s[c]) * a.scale;
      }
      *reinterpret_cast<float2*>(Pt + r * kPtld + 2 * tx) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(dSt + r * kPtld + 2 * tx) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();
    mm<DP>(dv, Pt, kPtld, dO, DP, kFaQ);
    mm<DP>(dk, dSt, kPtld, Q, DP, kFaQ);
  }
  T* dkb = head_out<T>(a.dk, a.s[kDk], b, h);
  T* dvb = head_out<T>(a.dv, a.s[kDv], b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= a.Tk) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = tile_col<DP>(tx, j);
      if (d < a.D) {
        put(dkb + (size_t)row * a.s[kDk][1] + d, dk[i][j]);
        put(dvb + (size_t)row * a.s[kDv][1] + d, dv[i][j]);
      }
    }
  }
}

// ------------------------------------------- bf16 operands: tensor cores
// Warp-level mma.sync products (mma.cuh): a warp owns 16 rows (q rows in the
// forward and dq kernels, key rows in dkdv) of one (b, h) head with its
// scores in registers; a block holds 1-4 such warps of the same head, which
// share the k / v (or q / do) tiles that the block streams through shared
// memory, double-buffered with cp.async.
constexpr int kTcWarps = 4;  // most warps a block
constexpr int kTcTile = 64;  // keys (fwd, dq) or queries (dkdv) per shared-memory tile

// Rows of a register block of the backward kernels: 32 at DP = 128, where
// two 16 x 128 fp32 accumulators already take 128 registers a thread
template <int DP>
__host__ __device__ constexpr int tc_chunk() {
  return DP == 128 ? 32 : 64;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + R - 1 of one head's (t, d) slice (`rows` rows, row stride
// row_stride) into a shared tile [R][DP + 8] (the padding keeps ldmatrix's 8
// row addresses on 8 bank quads), zero at or past `rows` or D: 16-byte
// cp.async with zero fill when vec (D, every stride and pointer 8-element
// aligned; the caller commits the group), else element loads.
template <int DP>
__device__ void tile_to_smem(bf16* dst, const bf16* src, int row_stride, int r0, int R, int rows,
                             int D, bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;
  if (vec) {
    for (int e = threadIdx.x; e < R * CH; e += blockDim.x) {
      const int r = e / CH, ch = e % CH;
      const bool in = r0 + r < rows && 8 * ch < D;
      cp_async16(dst + r * LD + 8 * ch, in ? src + (size_t)(r0 + r) * row_stride + 8 * ch : src,
                 in ? 16 : 0);
    }
  } else {
    const bf16 z = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < R * DP; e += blockDim.x) {
      const int r = e / DP, d = e % DP;
      dst[r * LD + d] = r0 + r < rows && d < D ? src[(size_t)(r0 + r) * row_stride + d] : z;
    }
  }
}

// A warp's 16 x DP accumulator, each row h (g, g + 8) divided by div[h],
// into bf16 rows m0 + g + 8 h < M of base (columns below D)
template <int DP>
__device__ void store_acc(const float (*acc)[4], const float* div, bf16* base, int row_stride,
                          int m0, int M, int D, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    if (r >= M) continue;
    bf16* row = base + (size_t)r * row_stride;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int col = 8 * d + 2 * c;
      const float x0 = acc[d][2 * h] / div[h], x1 = acc[d][2 * h + 1] / div[h];
      if (vec) {  // D is a multiple of 8: a pair is in or out as a whole
        if (col < D) *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) row[col] = __float2bfloat16(x0);
        if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
}

// Shared-memory bytes of the tensor-core kernels for blocks of nw warps
template <int DP>
constexpr size_t fwd_tc_smem(int nw) {  // Q [16 nw][LD], K, V [2][64][LD]
  return (size_t)(16 * nw + 4 * kTcTile) * (DP + 8) * sizeof(bf16);
}
template <int DP>
constexpr size_t dq_tc_smem(int nw) {  // Q, dO [16 nw][LD], K, V [2][64][LD], lse, delta [16 nw]
  return (size_t)(32 * nw + 4 * kTcTile) * (DP + 8) * sizeof(bf16) + 32 * nw * sizeof(float);
}
template <int DP>
constexpr size_t dkdv_tc_smem(int nw) {  // K, V [16 nw][LD], Q, dO [2][64][LD], lse, delta [2][64]
  return (size_t)(32 * nw + 4 * kTcTile) * (DP + 8) * sizeof(bf16) + 4 * kTcTile * sizeof(float);
}

// Forward: the block's warps own q rows q0 + 16 w .. of head (b, h); k / v
// stream in 64-key tiles; the online softmax keeps each row's running max
// m and (per lane) sum l; o += exp(s - m) v with fp32 P (pv_step's hi / lo
// split), rescaled when m grows; o / l and lse = m + log l at the end.
template <int DP>
__device__ void fwd_tc(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 8, KT = kTcTile;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + 16 * nw * LD;
  bf16* Vs = Ks + 2 * KT * LD;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, q0 = blockIdx.y * 16 * nw;
  const bf16* kb = head<bf16>(a.k, a.s[kK], b, h);
  const bf16* vb = head<bf16>(a.v, a.s[kV], b, h);
  const int tiles = (a.Tk + KT - 1) / KT;
  tile_to_smem<DP>(Qs, head<bf16>(a.q, a.s[kQ], b, h), a.s[kQ][1], q0, 16 * nw, a.Tq, a.D, a.vec);
  tile_to_smem<DP>(Ks, kb, a.s[kK][1], 0, KT, a.Tk, a.D, a.vec);
  tile_to_smem<DP>(Vs, vb, a.s[kV][1], 0, KT, a.Tk, a.D, a.vec);
  cp_async_commit();
  uint32_t qa[DP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[DP / 8][4];
  zero_acc<DP>(o);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {  // the next tile into the other buffer, consumed before the last barrier
      tile_to_smem<DP>(Ks + (buf ^ 1) * KT * LD, kb, a.s[kK][1], (t + 1) * KT, KT, a.Tk, a.D, a.vec);
      tile_to_smem<DP>(Vs + (buf ^ 1) * KT * LD, vb, a.s[kV][1], (t + 1) * KT, KT, a.Tk, a.D, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) load_q<DP, true>(qa, Qs + warp * 16 * LD, LD, 0, 16);
    const bf16* kt = Ks + buf * KT * LD;
    const bf16* vt = Vs + buf * KT * LD;
    const int nvalid = min(KT, a.Tk - t * KT);
    float s[KT / 8][4];
    scores<DP, KT / 8, true, true>(s, qa, kt, LD, 0, nvalid, a.scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) bm = fmaxf(bm, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(bm));  // finite: key t KT < Tk is in every tile
      const float alpha = expf(m[r] - mn);         // 0 on the first tile
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < DP / 8; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        s[j][2 * r] = expf(s[j][2 * r] - mn);
        s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mn);
        l[r] += s[j][2 * r] + s[j][2 * r + 1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      pv_step<DP, true, true>(o, s[2 * kk], s[2 * kk + 1], vt, LD, 16 * kk, nvalid);
    __syncthreads();
  }
  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const int m0 = q0 + 16 * warp;
  store_acc<DP>(o, lt, head_out<bf16>(a.out, a.s[kO], b, h), a.s[kO][1], m0, a.Tq, a.D, a.vec);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < a.Tq) a.lse[(size_t)bh * a.Tq + row] = m[r] + logf(lt[r]);
  }
}

// Backward, dq: the block's warps own q rows of head (b, h); delta =
// rowsum(do * o) (fp32, saved o) first, written for dkdv; then over 64-key
// tiles: P = exp(s - lse), dp = do v^T, ds = P (dp - delta) / sqrt(D) in
// fp32, dq += ds k with pv_step's hi / lo split.
template <int DP>
__device__ void dq_tc(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 8, KT = kTcTile, KC = tc_chunk<DP>();
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + 16 * nw * LD;
  bf16* Ks = dOs + 16 * nw * LD;
  bf16* Vs = Ks + 2 * KT * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * KT * LD);
  float* delta_s = lse_s + 16 * nw;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, q0 = blockIdx.y * 16 * nw;
  const bf16* kb = head<bf16>(a.k, a.s[kK], b, h);
  const bf16* vb = head<bf16>(a.v, a.s[kV], b, h);
  const bf16* dob = head<bf16>(a.dout, a.s[kDo], b, h);
  const bf16* ob = head<bf16>(a.o, a.s[kO], b, h);
  const int tiles = (a.Tk + KT - 1) / KT;
  tile_to_smem<DP>(Qs, head<bf16>(a.q, a.s[kQ], b, h), a.s[kQ][1], q0, 16 * nw, a.Tq, a.D, a.vec);
  tile_to_smem<DP>(dOs, dob, a.s[kDo][1], q0, 16 * nw, a.Tq, a.D, a.vec);
  tile_to_smem<DP>(Ks, kb, a.s[kK][1], 0, KT, a.Tk, a.D, a.vec);
  tile_to_smem<DP>(Vs, vb, a.s[kV][1], 0, KT, a.Tk, a.D, a.vec);
  cp_async_commit();
  // delta = rowsum(do * o) and lse of the warp's 16 rows: lanes 2i and 2i + 1
  // take row i, alternate 8-element chunks (16-byte loads when vec) each
  const int m0 = q0 + 16 * warp;
  {
    const int i = lane >> 1, half = lane & 1, row = m0 + i;
    float sum = 0.f;
    if (row < a.Tq) {
      const bf16* dr = dob + (size_t)row * a.s[kDo][1];
      const bf16* orow = ob + (size_t)row * a.s[kO][1];
      if (a.vec) {
        for (int d = 8 * half; d < a.D; d += 16) {
          const uint4 x = *reinterpret_cast<const uint4*>(dr + d);
          const uint4 y = *reinterpret_cast<const uint4*>(orow + d);
          const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fx = __bfloat1622float2(xp[j]), fy = __bfloat1622float2(yp[j]);
            sum += fx.x * fy.x + fx.y * fy.y;
          }
        }
      } else {
        for (int d = half; d < a.D; d += 2) sum += tof(dr[d]) * tof(orow[d]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[16 * warp + i] = sum;
      lse_s[16 * warp + i] = row < a.Tq ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
      if (row < a.Tq) a.delta[(size_t)bh * a.Tq + row] = sum;
    }
  }
  __syncwarp();
  const float lse_r[2] = {lse_s[16 * warp + g], lse_s[16 * warp + g + 8]};
  const float delta_r[2] = {delta_s[16 * warp + g], delta_s[16 * warp + g + 8]};
  uint32_t qa[DP / 16][4], da[DP / 16][4];
  float acc[DP / 8][4];
  zero_acc<DP>(acc);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      tile_to_smem<DP>(Ks + (buf ^ 1) * KT * LD, kb, a.s[kK][1], (t + 1) * KT, KT, a.Tk, a.D, a.vec);
      tile_to_smem<DP>(Vs + (buf ^ 1) * KT * LD, vb, a.s[kV][1], (t + 1) * KT, KT, a.Tk, a.D, a.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_q<DP, true>(qa, Qs + warp * 16 * LD, LD, 0, 16);
      load_q<DP, true>(da, dOs + warp * 16 * LD, LD, 0, 16);
    }
    for (int c0 = 0; c0 < KT; c0 += KC) {
      const int nvalid = min(KC, a.Tk - t * KT - c0);
      if (nvalid <= 0) break;
      const bf16* kt = Ks + (buf * KT + c0) * LD;
      float p[KC / 8][4], dp[KC / 8][4];
      scores<DP, KC / 8, true, true>(p, qa, kt, LD, 0, nvalid, a.scale);
      scores<DP, KC / 8, false, true>(dp, da, Vs + (buf * KT + c0) * LD, LD, 0, nvalid, a.scale);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = expf(p[j][e] - lse_r[e >> 1]) * (dp[j][e] - delta_r[e >> 1]) * a.scale;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        pv_step<DP, true, true>(acc, p[2 * kk], p[2 * kk + 1], kt, LD, 16 * kk, nvalid);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_acc<DP>(acc, one, head_out<bf16>(a.dq, a.s[kDq], b, h), a.s[kDq][1], m0, a.Tq, a.D, a.vec);
}

// Backward, dk / dv: the block's warps own key rows of head (b, h); q / do
// (and their rows' lse and delta) stream in 64-query tiles: P^T = exp(k q^T
// / sqrt(D) - lse), dp^T = v do^T, ds^T = P^T (dp^T - delta) / sqrt(D),
// dv += P^T do, dk += ds^T q (fp32 P and ds, hi / lo split).
template <int DP>
__device__ void dkdv_tc(const FlashArgs& a) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 8, QT = kTcTile, QC = tc_chunk<DP>();
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3;
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + 16 * nw * LD;
  bf16* Qs = Vs + 16 * nw * LD;
  bf16* dOs = Qs + 2 * QT * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QT * LD);  // [2][QT]
  float* delta_s = lse_s + 2 * QT;                            // [2][QT]
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, k0 = blockIdx.y * 16 * nw;
  const bf16* qb = head<bf16>(a.q, a.s[kQ], b, h);
  const bf16* dob = head<bf16>(a.dout, a.s[kDo], b, h);
  const float* lse = a.lse + (size_t)bh * a.Tq;
  const float* delta = a.delta + (size_t)bh * a.Tq;
  const int tiles = (a.Tq + QT - 1) / QT;
  auto stats = [&](int t, int buf) {
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const int row = t * QT + i;
      lse_s[buf * QT + i] = row < a.Tq ? lse[row] : 0.f;
      delta_s[buf * QT + i] = row < a.Tq ? delta[row] : 0.f;
    }
  };
  tile_to_smem<DP>(Ks, head<bf16>(a.k, a.s[kK], b, h), a.s[kK][1], k0, 16 * nw, a.Tk, a.D, a.vec);
  tile_to_smem<DP>(Vs, head<bf16>(a.v, a.s[kV], b, h), a.s[kV][1], k0, 16 * nw, a.Tk, a.D, a.vec);
  tile_to_smem<DP>(Qs, qb, a.s[kQ][1], 0, QT, a.Tq, a.D, a.vec);
  tile_to_smem<DP>(dOs, dob, a.s[kDo][1], 0, QT, a.Tq, a.D, a.vec);
  cp_async_commit();
  stats(0, 0);
  float dk[DP / 8][4], dv[DP / 8][4];
  zero_acc<DP>(dk);
  zero_acc<DP>(dv);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      tile_to_smem<DP>(Qs + (buf ^ 1) * QT * LD, qb, a.s[kQ][1], (t + 1) * QT, QT, a.Tq, a.D, a.vec);
      tile_to_smem<DP>(dOs + (buf ^ 1) * QT * LD, dob, a.s[kDo][1], (t + 1) * QT, QT, a.Tq, a.D,
                       a.vec);
      cp_async_commit();
      stats(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int c0 = 0; c0 < QT; c0 += QC) {
      const int nvalid = min(QC, a.Tq - t * QT - c0);
      if (nvalid <= 0) break;
      const bf16* qt = Qs + (buf * QT + c0) * LD;
      const bf16* dot = dOs + (buf * QT + c0) * LD;
      float p[QC / 8][4], ds[QC / 8][4];
      {
        uint32_t ka[DP / 16][4];
        load_q<DP, true>(ka, Ks + warp * 16 * LD, LD, 0, 16);
        scores<DP, QC / 8, true, true>(p, ka, qt, LD, 0, nvalid, a.scale);  // s^T
      }
      {
        uint32_t va[DP / 16][4];
        load_q<DP, true>(va, Vs + warp * 16 * LD, LD, 0, 16);
        scores<DP, QC / 8, false, true>(ds, va, dot, LD, 0, nvalid, a.scale);  // dp^T
      }
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = buf * QT + c0 + 8 * j + 2 * c + (e & 1);  // masked columns: p = 0
          p[j][e] = expf(p[j][e] - lse_s[i]);
          ds[j][e] = p[j][e] * (ds[j][e] - delta_s[i]) * a.scale;
        }
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        pv_step<DP, true, true>(dv, p[2 * kk], p[2 * kk + 1], dot, LD, 16 * kk, nvalid);
        pv_step<DP, true, true>(dk, ds[2 * kk], ds[2 * kk + 1], qt, LD, 16 * kk, nvalid);
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const int j0 = k0 + 16 * warp;
  store_acc<DP>(dk, one, head_out<bf16>(a.dk, a.s[kDk], b, h), a.s[kDk][1], j0, a.Tk, a.D, a.vec);
  store_acc<DP>(dv, one, head_out<bf16>(a.dv, a.s[kDv], b, h), a.s[kDv][1], j0, a.Tk, a.D, a.vec);
}

// The kernels: bf16 instances on the tensor cores, float32 ones scalar
template <int DP, class T>
__global__ void __launch_bounds__(kFaThreads) flash_fwd_kernel(FlashArgs a) {
  if constexpr (std::is_same_v<T, bf16>) {
    fwd_tc<DP>(a);
  } else {
    fwd_scalar<DP, T>(a);
  }
}
template <int DP, class T>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dq_kernel(FlashArgs a) {
  if constexpr (std::is_same_v<T, bf16>) {
    dq_tc<DP>(a);
  } else {
    dq_scalar<DP, T>(a);
  }
}
template <int DP, class T>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dkdv_kernel(FlashArgs a) {
  if constexpr (std::is_same_v<T, bf16>) {
    dkdv_tc<DP>(a);
  } else {
    dkdv_scalar<DP, T>(a);
  }
}

template <class Kernel>
static int launch(Kernel kernel, dim3 grid, int threads, size_t bytes, const FlashArgs& a,
                  cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
struct TypeTag {
  using type = T;
};

// f(std::integral_constant<int, DP>, TypeTag<T>) for the instance that takes
// head_dim D and dtype (0 float32, 1 bfloat16).
template <class F>
static int dispatch(int D, int dtype, F&& f) {
  auto by_dim = [&](auto tag) {
    if (D <= 32) return f(std::integral_constant<int, 32>{}, tag);
    if (D <= 64) return f(std::integral_constant<int, 64>{}, tag);
    return f(std::integral_constant<int, 128>{}, tag);
  };
  return dtype == 1 ? by_dim(TypeTag<bf16>{}) : by_dim(TypeTag<float>{});
}

// ints: B, H, Tq, Tk, D, dtype, then n_strided (b, t, h) stride triples;
// vec when the operands are bf16 and every stride, D and pointer in ptrs
// (n_strided of them) is 8-element aligned (the tensor-core kernels' 16-byte
// copies)
static int setup(FlashArgs& a, const int* ints, int n_strided, const void* const* ptrs,
                 int* dtype) {
  a.B = ints[0];
  a.H = ints[1];
  a.Tq = ints[2];
  a.Tk = ints[3];
  a.D = ints[4];
  *dtype = ints[5];
  bool vec = *dtype == 1 && a.D % 8 == 0;
  for (int i = 0; i < n_strided; ++i) {
    for (int j = 0; j < 3; ++j) {
      a.s[i][j] = ints[6 + 3 * i + j];
      vec = vec && a.s[i][j] % 8 == 0;
    }
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  }
  a.vec = vec ? 1 : 0;
  if (a.B < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1 || a.D < 1 || a.D > 128 ||
      (*dtype != 0 && *dtype != 1) || (a.Tq + 15) / 16 > 65535 || (a.Tk + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)a.D));
  return 0;
}

// Launch shape over `rows` rows: the scalar kernels' 64-row blocks of
// kFaThreads threads; the tensor-core kernels' blocks of nw <= 4 warps of 16
// rows each, all of one head
struct Shape {
  dim3 grid;
  int threads, nw;
};
static Shape shape(const FlashArgs& a, int rows, bool tc) {
  if (!tc) return {dim3(a.B * a.H, (rows + kFaRows - 1) / kFaRows), kFaThreads, 0};
  const int tiles = (rows + 15) / 16, nw = tiles < kTcWarps ? tiles : kTcWarps;
  return {dim3(a.B * a.H, (tiles + nw - 1) / nw), 32 * nw, nw};
}

}  // namespace sd

// ptrs: q, k, v, o, lse (B, H, Tq) fp32
// ints: B, H, Tq, Tk, D, dtype (0 float32, 1 bfloat16), then the (b, t, h)
//       element strides of q, k, v, o
extern "C" int sd_flash_attention_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  FlashArgs a = {};
  int dtype;
  if (int err = setup(a, ints, 4, ptrs, &dtype)) return err;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.out = const_cast<void*>(ptrs[3]);
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a.D, dtype, [&](auto dp, auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int DP = decltype(dp)::value;
    constexpr bool tc = std::is_same_v<T, bf16>;
    const Shape s = shape(a, a.Tq, tc);
    const size_t bytes = tc ? fwd_tc_smem<DP>(s.nw) : fwd_smem<DP>() * sizeof(float);
    return launch(flash_fwd_kernel<DP, T>, s.grid, s.threads, bytes, a, st);
  });
}

// ptrs: q, k, v, o, do, dq, dk, dv, lse, delta (B, H, Tq) fp32 scratch
// ints: B, H, Tq, Tk, D, dtype, then the (b, t, h) element strides of
//       q, k, v, o, do, dq, dk, dv
extern "C" int sd_flash_attention_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  FlashArgs a = {};
  int dtype;
  if (int err = setup(a, ints, 8, ptrs, &dtype)) return err;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.o = ptrs[3];
  a.dout = ptrs[4];
  a.dq = const_cast<void*>(ptrs[5]);
  a.dk = const_cast<void*>(ptrs[6]);
  a.dv = const_cast<void*>(ptrs[7]);
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[8]));
  a.delta = static_cast<float*>(const_cast<void*>(ptrs[9]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a.D, dtype, [&](auto dp, auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int DP = decltype(dp)::value;
    constexpr bool tc = std::is_same_v<T, bf16>;
    // dq_kernel writes delta, which dkdv_kernel reads: same stream, in order
    const Shape sq = shape(a, a.Tq, tc), sk = shape(a, a.Tk, tc);
    const int err = launch(flash_bwd_dq_kernel<DP, T>, sq.grid, sq.threads,
                           tc ? dq_tc_smem<DP>(sq.nw) : dq_smem<DP>() * sizeof(float), a, st);
    if (err != 0) return err;
    return launch(flash_bwd_dkdv_kernel<DP, T>, sk.grid, sk.threads,
                  tc ? dkdv_tc_smem<DP>(sk.nw) : dkdv_smem<DP>() * sizeof(float), a, st);
  });
}
