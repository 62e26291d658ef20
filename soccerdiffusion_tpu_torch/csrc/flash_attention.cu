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
// its two kernels) are 3.5x the forward's. This kernel does scalar fp32
// FMAs from shared-memory tiles (4 x 4 register blocking per thread, as
// weight_grads.cu), so it is bound by fp32 instruction throughput;
// tensor-core products are left for a redesign. Design:
//   * the TPU wrapper's constructs are not carried over: no padding of D to
//     128 lanes or of T to sublanes in device memory, no (B*H, T, D)
//     fold / transpose copies (the kernels read and write the (B, T, H, D)
//     tensors in place through their (b, t, h) strides), and no split
//     between a single-tile and a streamed variant (which exists because of
//     VMEM's size): the forward streams 64-key tiles with the online-softmax
//     recursion at every Tk;
//   * the head dimension is a template parameter DP in {32, 64, 128}; a
//     head_dim D <= DP is read with the lanes d >= D as zeros and written
//     only below D (any D from 1 to 128);
//   * forward: one block per (b*h, 64-row q tile), 256 threads, q in shared
//     memory for the whole loop, the k tile transposed and the v tile
//     natural in shared memory, the (64 x 64) probability tile written
//     back to shared memory for the value product; writes o and the fp32
//     row log-sum-exp;
//   * backward: deterministic, without atomics, in two kernels (as
//     weight_grads.cu does for the weight gradients): dq_kernel, one block
//     per (b*h, 64-row q tile), loops over the k tiles and also writes delta;
//     dkdv_kernel, one block per (b*h, 64-row k tile), loops over 32-row q
//     tiles. Both recompute p = exp(s * scale - lse); every output element
//     is one thread's sum in a fixed order.
#include <type_traits>

#include "common.cuh"

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
__global__ void __launch_bounds__(kFaThreads) flash_fwd_kernel(FlashArgs a) {
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
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dq_kernel(FlashArgs a) {
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
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dkdv_kernel(FlashArgs a) {
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

template <class Kernel>
static int launch(Kernel kernel, dim3 grid, size_t smem_floats, const FlashArgs& a,
                  cudaStream_t stream) {
  const int bytes = (int)(smem_floats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kFaThreads, bytes, stream>>>(a);
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

// ints: B, H, Tq, Tk, D, dtype, then n_strided (b, t, h) stride triples
static int setup(FlashArgs& a, const int* ints, int n_strided, int* dtype) {
  a.B = ints[0];
  a.H = ints[1];
  a.Tq = ints[2];
  a.Tk = ints[3];
  a.D = ints[4];
  *dtype = ints[5];
  for (int i = 0; i < n_strided; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = ints[6 + 3 * i + j];
  if (a.B < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1 || a.D < 1 || a.D > 128 ||
      (*dtype != 0 && *dtype != 1) || (a.Tq + kFaRows - 1) / kFaRows > 65535 ||
      (a.Tk + kFaRows - 1) / kFaRows > 65535)
    return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)a.D));
  return 0;
}

}  // namespace sd

// ptrs: q, k, v, o, lse (B, H, Tq) fp32
// ints: B, H, Tq, Tk, D, dtype (0 float32, 1 bfloat16), then the (b, t, h)
//       element strides of q, k, v, o
extern "C" int sd_flash_attention_fwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  FlashArgs a = {};
  int dtype;
  if (int err = setup(a, ints, 4, &dtype)) return err;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.out = const_cast<void*>(ptrs[3]);
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
  const dim3 grid(a.B * a.H, (a.Tq + kFaRows - 1) / kFaRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a.D, dtype, [&](auto dp, auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int DP = decltype(dp)::value;
    return launch(flash_fwd_kernel<DP, T>, grid, fwd_smem<DP>(), a, st);
  });
}

// ptrs: q, k, v, o, lse, do, dq, dk, dv, delta (B, H, Tq) fp32 scratch
// ints: B, H, Tq, Tk, D, dtype, then the (b, t, h) element strides of
//       q, k, v, o, do, dq, dk, dv
extern "C" int sd_flash_attention_bwd(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  FlashArgs a = {};
  int dtype;
  if (int err = setup(a, ints, 8, &dtype)) return err;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.o = ptrs[3];
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
  a.dout = ptrs[5];
  a.dq = const_cast<void*>(ptrs[6]);
  a.dk = const_cast<void*>(ptrs[7]);
  a.dv = const_cast<void*>(ptrs[8]);
  a.delta = static_cast<float*>(const_cast<void*>(ptrs[9]));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a.D, dtype, [&](auto dp, auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int DP = decltype(dp)::value;
    // dq_kernel writes delta, which dkdv_kernel reads: same stream, in order
    const int err = launch(flash_bwd_dq_kernel<DP, T>,
                           dim3(a.B * a.H, (a.Tq + kFaRows - 1) / kFaRows), dq_smem<DP>(), a, st);
    if (err != 0) return err;
    return launch(flash_bwd_dkdv_kernel<DP, T>, dim3(a.B * a.H, (a.Tk + kFaRows - 1) / kFaRows),
                  dkdv_smem<DP>(), a, st);
  });
}
