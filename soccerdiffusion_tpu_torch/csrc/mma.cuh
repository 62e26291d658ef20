// Warp-level bf16 tensor-core products (mma.sync m16n8k16, fp32
// accumulators) for the fused ViT block and the encoder layer
// (encoder_layer.cuh), the decoder layer (fused_decoder_layer.cu) and the
// bf16 flash-attention kernels (flash_attention.cu), forward and backward.
//
// Fragments follow the PTX ISA's m16n8k16 .bf16 layout: with g = lane / 4
// and c = lane % 4, A register 0 holds (row g, cols 2c, 2c+1), 1 (row g+8,
// the same cols), 2 (row g, cols 2c+8, 2c+9), 3 (row g+8, cols 2c+8, 2c+9);
// B register 0 holds (rows 2c, 2c+1, col g), 1 (rows 2c+8, 2c+9, col g); the
// accumulator (row g, cols 2c, 2c+1) and (row g+8, cols 2c, 2c+1). Every
// operand is already bf16 at the plain versions' rounding points (LayerNorm
// outputs, q/k/v, head outputs, the GELU output, bf16(P), every backward
// operand), so a product here differs from the scalar one by the order of
// its fp32 sums only; the flash kernel's fp32 P (and ds) is a sum of two
// bf16 operands (pv_step).
//
// Operands in shared memory are read with ldmatrix (rows padded so that its
// 8 row addresses hit 8 different bank quads); in global memory with 16-byte
// loads along the reduction axis (mma_dense_rows), 32-bit loads (two bf16
// along that axis), or two 16-bit loads where the operand is stored across
// it; every stride and column offset is even. Ragged edges are masked at
// the m16 / n8 / k16 tile edges: rows or columns past the end read as 0 or
// repeat the last row (the reduction length is a multiple of 8, so a column
// pair is in or out as a whole) and their results are not stored.
#pragma once

#include "train_common.cuh"

namespace sd {

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {  // p[0] low, p[1] high
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_round(float lo, float hi) {  // round-to-nearest-even
  return pack_pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

// c += a . b on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tile (rows m0.., cols k0..) of a row-major X (M, K), row stride ld
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* X, int ld, int m0, int k0, int M,
                                       int K) {
  const int lane = threadIdx.x & 31, r = m0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const bool r0 = r < M, r1 = r + 8 < M, k0in = k < K, k1in = k + 8 < K;
  a[0] = r0 && k0in ? ld_pair(X + (size_t)r * ld + k) : 0u;
  a[1] = r1 && k0in ? ld_pair(X + (size_t)(r + 8) * ld + k) : 0u;
  a[2] = r0 && k1in ? ld_pair(X + (size_t)r * ld + k + 8) : 0u;
  a[3] = r1 && k1in ? ld_pair(X + (size_t)(r + 8) * ld + k + 8) : 0u;
}

// four 8 x 8 bf16 matrices from shared memory (lane t gives the row address
// of matrix t / 8, row t % 8), as they are or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// load_a for an X in shared memory: one ldmatrix.x4 (X 16-byte aligned, ld
// a multiple of 8). Rows past M read row M - 1 (their results are not
// stored); the upper half of a k16 tile past K reads as 0.
__device__ __forceinline__ void load_a_sm(uint32_t* a, const bf16* X, int ld, int m0, int k0,
                                          int M, int K) {
  const int lane = threadIdx.x & 31, r = min(m0 + (lane & 15), M - 1);
  const bool hi_in = k0 + 8 < K;
  ldsm_x4(a, X + (size_t)r * ld + k0 + (hi_in ? (lane >> 4) * 8 : 0));
  if (!hi_in) a[2] = a[3] = 0u;
}

// B tile (reduction rows k0.., cols n0..) of B = Bt^T, Bt row-major (N, K):
// a weight matrix stored (out, in), or the rows of k / v / dom / q
__device__ __forceinline__ void load_b_t(uint32_t* b, const bf16* Bt, int ld, int n0, int k0,
                                         int N, int K) {
  const int lane = threadIdx.x & 31, n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const bool nin = n < N;
  b[0] = nin && k < K ? ld_pair(Bt + (size_t)n * ld + k) : 0u;
  b[1] = nin && k + 8 < K ? ld_pair(Bt + (size_t)n * ld + k + 8) : 0u;
}

// B tile of a row-major B (K, N): two 16-bit loads a register
__device__ __forceinline__ void load_b_n(uint32_t* b, const bf16* B, int ld, int n0, int k0, int N,
                                         int K) {
  const int lane = threadIdx.x & 31, n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const bf16 z = __float2bfloat16(0.f);
  const bool nin = n < N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = k + 8 * h;
    const bf16 lo = nin && kk < K ? B[(size_t)kk * ld + n] : z;
    const bf16 hi = nin && kk + 1 < K ? B[(size_t)(kk + 1) * ld + n] : z;
    b[h] = pack_pair(lo, hi);
  }
}

// The A fragment of a 16 x 16 tile whose values sit in two accumulator
// tiles (columns 0-7 in lo, 8-15 in hi), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_round(lo[0], lo[1]);
  a[1] = pack_round(lo[2], lo[3]);
  a[2] = pack_round(hi[0], hi[1]);
  a[3] = pack_round(hi[2], hi[3]);
}

// Y[M, N] = X[M, K] . Wt[N, K]^T + bias[N], handed to epi(m, n, y) once per
// element. Wt bf16 row-major (N, K), row stride ldw, in global memory
// (L2-resident: every block reads the same weights): a weight matrix stored
// (out, in). Block-cooperative: each warp takes items of MT m16 tiles x NT
// n8 tiles (16 MT rows x 8 NT columns) and runs the whole reduction over
// them: a B fragment serves MT products, an A fragment NT. Two forms:
//   * mma_dense (kSmemA): X in shared memory, A fragments by ldmatrix and B
//     by 32-bit loads, 16 columns of K at a time;
//   * mma_dense_rows: X in global memory (a workspace this block wrote) or
//     in shared memory (generic loads: where MT = 1, the 16-byte B loads
//     below move 4x the bytes of the 32-bit ones per L1 wavefront);
//     lane c reads columns 8c .. 8c + 7 of its two A rows and of its B row
//     as one 16-byte load each, 32 columns of K at a time (X and Wt 16-byte
//     aligned, 8-element strides), and feeds them to the two k16 products
//     as columns (2c, 2c+1, 2c+8, 2c+9) of each: the same 32 products,
//     summed in another order.
// Columns past K read as 0; rows past M or N are not stored. No
// __syncthreads inside: the caller orders X's writes before and epi's
// writes after.
template <int MT, int NT, bool kSmemA, bool kBias, class Epi>
__device__ void mma_dense_impl(const bf16* X, int ldx, int M, int K, const bf16* __restrict__ Wt,
                               int ldw, int N, const bf16* __restrict__ bias, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int col_items = (N + 8 * NT - 1) / (8 * NT);
  const int items = col_items * ((M + 16 * MT - 1) / (16 * MT));
  for (int item = warp; item < items; item += nwarps) {
    const int m0 = (item / col_items) * 16 * MT, n0 = (item % col_items) * 8 * NT;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    if constexpr (kSmemA) {
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) load_a_sm(a[i], X, ldx, m0 + 16 * i, k0, M, K);
#pragma unroll
        for (int j = 0; j < NT; ++j) load_b_t(b[j], Wt, ldw, n0 + 8 * j, k0, N, K);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    } else {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 32) {
        const bool kin = k0 + 8 * c < K;  // this lane's 8 columns
        uint4 av[MT][2], bv[NT];          // rows g and g + 8 of each m16 tile; row g of each n8
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = min(m0 + 16 * i + g + 8 * h, M - 1);
            av[i][h] = kin ? *reinterpret_cast<const uint4*>(X + (size_t)r * ldx + k0 + 8 * c) : zero;
          }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = min(n0 + 8 * j + g, N - 1);
          bv[j] = kin ? *reinterpret_cast<const uint4*>(Wt + (size_t)n * ldw + k0 + 8 * c) : zero;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t a0[4] = {av[i][0].x, av[i][1].x, av[i][0].y, av[i][1].y};
          const uint32_t a1[4] = {av[i][0].z, av[i][1].z, av[i][0].w, av[i][1].w};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b0[2] = {bv[j].x, bv[j].y}, b1[2] = {bv[j].z, bv[j].w};
            mma_bf16(acc[i][j], a0, b0);
            mma_bf16(acc[i][j], a1, b1);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + 2 * c;
      if (n >= N) continue;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (kBias) {
        b0 = tof(bias[n]);
        b1 = tof(bias[n + 1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * i + g + 8 * h;
          if (m < M) {
            epi(m, n, acc[i][j][2 * h] + b0);
            epi(m, n + 1, acc[i][j][2 * h + 1] + b1);
          }
        }
      }
    }
  }
}

template <int MT = 2, int NT = 4, class Epi>
__device__ void mma_dense(const bf16* X, int ldx, int M, int K, const bf16* __restrict__ Wt,
                          int ldw, int N, const bf16* __restrict__ bias, Epi epi) {
  mma_dense_impl<MT, NT, true, true>(X, ldx, M, K, Wt, ldw, N, bias, epi);
}
template <int MT = 2, int NT = 4, class Epi>
__device__ void mma_dense(const bf16* X, int ldx, int M, int K, const bf16* __restrict__ Wt,
                          int ldw, int N, std::nullptr_t, Epi epi) {
  mma_dense_impl<MT, NT, true, false>(X, ldx, M, K, Wt, ldw, N, nullptr, epi);
}
template <int MT = 2, int NT = 4, class Epi>
__device__ void mma_dense_rows(const bf16* X, int ldx, int M, int K, const bf16* __restrict__ Wt,
                               int ldw, int N, const bf16* __restrict__ bias, Epi epi) {
  mma_dense_impl<MT, NT, false, true>(X, ldx, M, K, Wt, ldw, N, bias, epi);
}
template <int MT = 2, int NT = 4, class Epi>
__device__ void mma_dense_rows(const bf16* X, int ldx, int M, int K, const bf16* __restrict__ Wt,
                               int ldw, int N, std::nullptr_t, Epi epi) {
  mma_dense_impl<MT, NT, false, false>(X, ldx, M, K, Wt, ldw, N, nullptr, epi);
}

// ------------------------------------------------------------- attention
// One head's slices: q (and dom, the output gradient) are Tq rows of D bf16
// at a row stride, k and v Tk rows at another (self-attention: Tq = Tk, all
// three in one q | k | v row; cross-attention and flash attention: separate
// buffers, Tq != Tk). A warp owns 16 query (or key) rows and keeps its
// scores in registers, KB keys (or queries) at a time, with the row max and
// sum taken by quad shuffles. Keys past Tk score -inf; queries past Tq are
// neither stored nor counted.

// quad (the 4 lanes of one accumulator row) reductions
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s[j] = A . (Bt rows j0 + 8 j ..)^T over D for NB n8 tiles: with kScaled,
// times `scale` (1 / sqrt(D) unless given) and -inf in the columns at or
// past nvalid (scores); else the plain products with 0 there (dp = dom v^T)
// (kSm: Bt in shared memory, read with ldmatrix; rows past nvalid read row
// nvalid - 1 and are masked as above)
template <int D, int NB, bool kScaled = true, bool kSm = false>
__device__ __forceinline__ void scores(float (*s)[4], uint32_t (*a)[4], const bf16* Bt, int ld,
                                       int j0, int nvalid, float scale = attn_scale<D>()) {
  const int lane = threadIdx.x & 31, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kSm && D == 16) {
      // one k16 step: matrices 0 and 1 of the x4 load (lanes 16-31 repeat
      // the addresses of lanes 0-15)
      const int n = min(j0 + 8 * j + (lane & 7), nvalid - 1);
      uint32_t r[4];
      ldsm_x4(r, Bt + (size_t)n * ld + 8 * ((lane >> 3) & 1));
      const uint32_t b0[2] = {r[0], r[1]};
      mma_bf16(s[j], a[0], b0);
    } else if constexpr (kSm) {
      const int n = min(j0 + 8 * j + (lane & 7), nvalid - 1);
#pragma unroll
      for (int kd = 0; kd < D / 32; ++kd) {
        uint32_t r[4];
        ldsm_x4(r, Bt + (size_t)n * ld + 32 * kd + 8 * (lane >> 3));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(s[j], a[2 * kd], b0);
        mma_bf16(s[j], a[2 * kd + 1], b1);
      }
    } else {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t b[2];
        load_b_t(b, Bt, ld, j0 + 8 * j, 16 * kd, nvalid, D);
        mma_bf16(s[j], a[kd], b);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = j0 + 8 * j + 2 * c + (e & 1) < nvalid;
      if constexpr (kScaled) {
        s[j][e] = in ? s[j][e] * scale : -INFINITY;
      } else {
        s[j][e] = in ? s[j][e] : 0.f;
      }
    }
  }
}

// o (16 x D: D / 8 accumulator tiles) += P . V over the 16 rows key0 ..
// key0 + 15 of V (row-major (key, D), row stride ld: the values, or k / q /
// dom in the backward products), P's 16 columns in two accumulator tiles
// (columns 0-7 in plo, 8-15 in phi). Rows at or past nkeys read row nkeys
// - 1 (kSm: V in shared memory, read with ldmatrix.trans) or 0; their P
// columns must be 0. Two numerics of the product:
//   * rounded (kFp32P false): one product of bf16(P), the layer kernels'
//     (their plain versions round the normalised probabilities, and ds,
//     before the value sum);
//   * fp32 P (kFp32P true): the flash kernel's. Its TPU kernel never rounds
//     P (or ds), and the tensor cores take bf16 operands only, so P is split
//     into hi = bf16(P) and lo = bf16(P - hi) and both are multiplied by V:
//     hi + lo keeps 16 of P's 24 mantissa bits (|P - hi - lo| <= 2^-17 |P|),
//     against 8 for bf16(P). The second product is cheap where the kernel
//     is bound by bytes.
__device__ __forceinline__ uint32_t pack_lo(float a, float b) {  // bf16(x - bf16(x)) of a pair
  return pack_round(a - __bfloat162float(__float2bfloat16(a)),
                    b - __bfloat162float(__float2bfloat16(b)));
}
template <int D, bool kSm, bool kFp32P = false>
__device__ __forceinline__ void pv_step(float (*o)[4], const float* plo, const float* phi,
                                        const bf16* v, int ld, int key0, int nkeys) {
  constexpr int NP = kFp32P ? 2 : 1;
  const int lane = threadIdx.x & 31;
  uint32_t pa[NP][4];
  acc_to_a(pa[0], plo, phi);
  if constexpr (kFp32P) {
    pa[1][0] = pack_lo(plo[0], plo[1]);
    pa[1][1] = pack_lo(plo[2], plo[3]);
    pa[1][2] = pack_lo(phi[0], phi[1]);
    pa[1][3] = pack_lo(phi[2], phi[3]);
  }
  if constexpr (kSm) {
    // v^T fragments of the 16 keys, two n8 tiles a load
    const int key = min(key0 + (lane & 7) + 8 * ((lane >> 3) & 1), nkeys - 1);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      uint32_t r[4];
      ldsm_x4_trans(r, v + (size_t)key * ld + 16 * d + 8 * (lane >> 4));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        mma_bf16(o[2 * d], pa[p], b0);
        mma_bf16(o[2 * d + 1], pa[p], b1);
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      uint32_t b[2];
      load_b_n(b, v, ld, 8 * d, key0, D, nkeys);
#pragma unroll
      for (int p = 0; p < NP; ++p) mma_bf16(o[d], pa[p], b);
    }
  }
}

// Row max and sum of exp over all Tk keys for the warp's rows g and g + 8
// (the online form across key blocks; within a block the exact one).
template <int D, int KB, bool kSm = false>
__device__ __forceinline__ void softmax_stats(uint32_t (*qa)[4], const bf16* k, int ldk, int Tk,
                                              float* mx, float* sum) {
  mx[0] = mx[1] = -INFINITY;
  float part[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tk; j0 += KB) {
    float s[KB / 8][4];
    scores<D, KB / 8, true, kSm>(s, qa, k, ldk, j0, Tk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) bm = fmaxf(bm, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      const float m = fmaxf(mx[h], quad_max(bm));
      part[h] *= expf(mx[h] - m);
#pragma unroll
      for (int j = 0; j < KB / 8; ++j) part[h] += expf(s[j][2 * h] - m) + expf(s[j][2 * h + 1] - m);
      mx[h] = m;
    }
  }
  sum[0] = quad_sum(part[0]);
  sum[1] = quad_sum(part[1]);
}

// the q fragments of query rows m0 .. m0 + 15 (kSm: q in shared memory)
template <int D, bool kSm>
__device__ __forceinline__ void load_q(uint32_t (*qa)[4], const bf16* q, int ldq, int m0, int Tq) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    if constexpr (kSm) {
      load_a_sm(qa[kd], q, ldq, m0, 16 * kd, Tq, D);
    } else {
      load_a(qa[kd], q, ldq, m0, 16 * kd, Tq, D);
    }
  }
}

// the warp's rows g and g + 8 of a 16 x D accumulator into bf16 out (rows
// m0 + r < M)
template <int D>
__device__ __forceinline__ void store_rows(const float (*acc)[4], int m0, int M, bf16* out,
                                           int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ldo + 8 * d + 2 * c) =
          __floats2bfloat162_rn(acc[d][2 * h], acc[d][2 * h + 1]);
  }
}

// Forward of one head for query rows m0 .. m0 + 15:
//   out = bf16( bf16(softmax(q k^T / sqrt(D))) v )
// (kSm: q, k, v in shared memory, read with ldmatrix; keys past Tk read key
// Tk - 1, whose probability is exactly 0)
template <int D, bool kSm>
__device__ void attn_fwd_tile(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                              int ldk, int Tk, int m0, bf16* out, int ldo) {
  constexpr int KB = 64;
  uint32_t qa[D / 16][4];
  load_q<D, kSm>(qa, q, ldq, m0, Tq);
  float mx[2], sum[2];
  softmax_stats<D, KB, kSm>(qa, k, ldk, Tk, mx, sum);
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += KB) {
    float s[KB / 8][4];
    scores<D, KB / 8, true, kSm>(s, qa, k, ldk, j0, Tk);
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]) / sum[e >> 1];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      pv_step<D, kSm>(o, s[2 * kk], s[2 * kk + 1], v, ldk, j0 + 16 * kk, Tk);
  }
  store_rows<D>(o, m0, Tq, out, ldo);
}

// Every head's forward: warps take (head, 16-row tile) items; head h's
// slices start at column h D of q, k, v and out.
template <int D, bool kSm = false>
__device__ void attention_fwd(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                              int ldk, int Tk, int H, bf16* out, int ldo) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, tiles = (Tq + 15) / 16;
  for (int item = warp; item < H * tiles; item += nwarps) {
    const int h = item / tiles, m0 = (item % tiles) * 16;
    attn_fwd_tile<D, kSm>(q + h * D, ldq, Tq, k + h * D, v + h * D, ldk, Tk, m0, out + h * D, ldo);
  }
}

// Self-attention over T rows: qkv rows hold q | k | v (E = H D columns
// each), out rows the heads' outputs; kSm: qkv in shared memory.
template <int D, bool kSm = false>
__device__ void attention_fwd(const bf16* qkv, int ld, int T, int E, int H, bf16* out, int ldo) {
  attention_fwd<D, kSm>(qkv, ld, T, qkv + E, qkv + 2 * E, ld, T, H, out, ldo);
}

// keys per chunk of attn_fwd_split
constexpr int kSplitKeys = 32;

// Floats of attn_fwd_split's reduction buffer for Tk keys over nwarps warps
__host__ __device__ inline int split_red_floats(int D, int Tk, int nwarps) {
  const int nch = (Tk + kSplitKeys - 1) / kSplitKeys;
  return 32 * nch + 16 * D * (nch < nwarps ? nch : nwarps);
}

// Forward of one head with its q, k and v in shared memory, the same
// function as attn_fwd_tile, for few queries over many keys (the decoder's
// cross-attention, Tq = 10 over Tk = 312): attn_fwd_tile's (head, 16-row
// tile) items would leave one warp at work. Here every warp takes 32-key
// chunks: (1) each chunk's row max and sum of exp into `red`; (2) every
// warp combines them in chunk order into the rows' max and sum, then adds
// bf16(P) v of its chunks into its own 16 x D fp32 partial; (3) the
// partials are summed in warp order and rounded once. Deterministic; red
// holds split_red_floats(D, Tk, nwarps) floats of shared memory. Ends with
// __syncthreads.
template <int D>
__device__ void attn_fwd_split(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                               int ldk, int Tk, bf16* out, int ldo, float* red) {
  constexpr int KC = kSplitKeys;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int nch = (Tk + KC - 1) / KC, nslot = min(nch, nwarps);
  float* st = red;              // [nch][16][2]: a chunk's row max and sum of exp(s - max)
  float* part = red + 32 * nch;  // [nslot][16][D]
  for (int m0 = 0; m0 < Tq; m0 += 16) {
    uint32_t qa[D / 16][4];
    load_q<D, true>(qa, q, ldq, m0, Tq);
    for (int ch = warp; ch < nch; ch += nwarps) {
      float s[KC / 8][4];
      scores<D, KC / 8, true, true>(s, qa, k, ldk, ch * KC, Tk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bm = -INFINITY;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) bm = fmaxf(bm, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float m = quad_max(bm);  // finite: key ch * KC < Tk is in the chunk
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) e += expf(s[j][2 * h] - m) + expf(s[j][2 * h + 1] - m);
        e = quad_sum(e);
        if (c == 0) {
          st[2 * (ch * 16 + g + 8 * h)] = m;
          st[2 * (ch * 16 + g + 8 * h) + 1] = e;
        }
      }
    }
    __syncthreads();
    float mx[2], sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      float m = -INFINITY;
      for (int ch = 0; ch < nch; ++ch) m = fmaxf(m, st[2 * (ch * 16 + r)]);
      float l = 0.f;
      for (int ch = 0; ch < nch; ++ch)
        l += st[2 * (ch * 16 + r) + 1] * expf(st[2 * (ch * 16 + r)] - m);
      mx[h] = m;
      sum[h] = l;
    }
    float o[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    for (int ch = warp; ch < nch; ch += nwarps) {
      float s[KC / 8][4];
      scores<D, KC / 8, true, true>(s, qa, k, ldk, ch * KC, Tk);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - mx[e >> 1]) / sum[e >> 1];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        pv_step<D, true>(o, s[2 * kk], s[2 * kk + 1], v, ldk, ch * KC + 16 * kk, Tk);
    }
    if (warp < nslot) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          float* p = part + (size_t)(warp * 16 + g + 8 * h) * D + 8 * d + 2 * c;
          p[0] = o[d][2 * h];
          p[1] = o[d][2 * h + 1];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      if (m0 + r >= Tq) continue;
      float acc = 0.f;
      for (int w = 0; w < nslot; ++w) acc += part[(size_t)(w * 16 + r) * D + d];
      out[(size_t)(m0 + r) * ldo + d] = __float2bfloat16(acc);
    }
    __syncthreads();
  }
}

// Backward of one head, first half, for query rows m0 .. m0 + 15 (P, dp =
// dom v^T and ds recomputed from q, k, v, dom):
//   rs = rowsum(dp P) with fp32 P;  ds = bf16(P (dp - rs) / sqrt(D));
//   dq = bf16(ds k)
// and the rows' softmax max, sum and rs into stats (3 floats a row) for the
// second half. kSm: q, k, v and dom in shared memory, read with ldmatrix
// (the same products).
template <int D, bool kSm = false>
__device__ void attn_bwd_dq_tile(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                                 int ldk, int Tk, const bf16* dom, int ldd, int m0, bf16* dq,
                                 int lddq, float* stats) {
  constexpr int KB = 32, NB = KB / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_q<D, kSm>(qa, q, ldq, m0, Tq);
  load_q<D, kSm>(da, dom, ldd, m0, Tq);
  float mx[2], sum[2];
  softmax_stats<D, KB, kSm>(qa, k, ldk, Tk, mx, sum);
  // P and dp of one key block (fp32)
  auto block = [&](int j0, float (*p)[4], float (*dp)[4]) {
    scores<D, NB, true, kSm>(p, qa, k, ldk, j0, Tk);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = expf(p[j][e] - mx[e >> 1]) / sum[e >> 1];
    scores<D, NB, false, kSm>(dp, da, v, ldk, j0, Tk);
  };
  float part[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tk; j0 += KB) {
    float p[NB][4], dp[NB][4];
    block(j0, p, dp);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[e >> 1] += dp[j][e] * p[j][e];
  }
  const float rs[2] = {quad_sum(part[0]), quad_sum(part[1])};
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += KB) {
    float p[NB][4], dp[NB][4];
    block(j0, p, dp);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = p[j][e] * (dp[j][e] - rs[e >> 1]) * attn_scale<D>();
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk)  // ds, rounded to bf16, times k
      pv_step<D, kSm>(acc, p[2 * kk], p[2 * kk + 1], k, ldk, j0 + 16 * kk, Tk);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    if (r >= Tq) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)r * lddq + 8 * d + 2 * c) =
          __floats2bfloat162_rn(acc[d][2 * h], acc[d][2 * h + 1]);
    if (c == 0) {
      stats[3 * r] = mx[h];
      stats[3 * r + 1] = sum[h];
      stats[3 * r + 2] = rs[h];
    }
  }
}

// Backward of one head, second half, for key rows j0 .. j0 + 15 over every
// query (P^T and ds^T recomputed from k q^T, v dom^T and the stats of the
// first half):
//   dv = bf16(bf16(P)^T dom);  dk = bf16(ds^T q)
// With kSums also the fp32 (unrounded) column sums of the tile's dk and dv
// rows into ksum[0 .. D) / vsum[0 .. D) (the key / value bias gradients);
// with kSmQ, q and dom in shared memory (ldmatrix; the decoder's
// cross-attention, whose 10 query rows every key tile reads).
template <int D, bool kSums = false, bool kSmQ = false>
__device__ void attn_bwd_dkv_tile(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                                  int ldk, int Tk, const bf16* dom, int ldd, int j0,
                                  const float* stats, bf16* dk, int lddk, bf16* dv, int lddv,
                                  float* ksum = nullptr, float* vsum = nullptr) {
  constexpr int QB = 32, NB = QB / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    load_a(ka[kd], k, ldk, j0, 16 * kd, Tk, D);
    load_a(va[kd], v, ldk, j0, 16 * kd, Tk, D);
  }
  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[d][e] = av[d][e] = 0.f;
  for (int i0 = 0; i0 < Tq; i0 += QB) {
    float p[NB][4], ds[NB][4];
    scores<D, NB, true, kSmQ>(p, ka, q, ldq, i0, Tq);      // s^T / sqrt(D)
    scores<D, NB, false, kSmQ>(ds, va, dom, ldd, i0, Tq);  // dp^T = v dom^T
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * j + 2 * c + (e & 1);
        if (i < Tq) {
          const float* st = stats + 3 * i;
          p[j][e] = expf(p[j][e] - st[0]) / st[1];
          ds[j][e] = p[j][e] * (ds[j][e] - st[2]) * attn_scale<D>();
        } else {
          p[j][e] = ds[j][e] = 0.f;
        }
      }
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      if constexpr (kSmQ) {
        pv_step<D, true>(av, p[2 * kk], p[2 * kk + 1], dom, ldd, i0 + 16 * kk, Tq);  // bf16(P)^T dom
        pv_step<D, true>(ak, ds[2 * kk], ds[2 * kk + 1], q, ldq, i0 + 16 * kk, Tq);  // ds^T q
      } else {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, p[2 * kk], p[2 * kk + 1]);   // bf16(P)^T
        acc_to_a(sa, ds[2 * kk], ds[2 * kk + 1]); // ds^T, rounded to bf16
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          uint32_t b[2];
          load_b_n(b, dom, ldd, 8 * d, i0 + 16 * kk, D, Tq);
          mma_bf16(av[d], pa, b);
          load_b_n(b, q, ldq, 8 * d, i0 + 16 * kk, D, Tq);
          mma_bf16(ak[d], sa, b);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = j0 + g + 8 * h;
    if (r >= Tk) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)r * lddk + 8 * d + 2 * c) =
          __floats2bfloat162_rn(ak[d][2 * h], ak[d][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)r * lddv + 8 * d + 2 * c) =
          __floats2bfloat162_rn(av[d][2 * h], av[d][2 * h + 1]);
    }
  }
  if constexpr (kSums) {
    const bool in0 = j0 + g < Tk, in1 = j0 + g + 8 < Tk;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sk = (in0 ? ak[d][e] : 0.f) + (in1 ? ak[d][2 + e] : 0.f);
        float sv = (in0 ? av[d][e] : 0.f) + (in1 ? av[d][2 + e] : 0.f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sk += __shfl_xor_sync(0xffffffffu, sk, o);
          sv += __shfl_xor_sync(0xffffffffu, sv, o);
        }
        if (g == 0) {
          ksum[8 * d + 2 * c + e] = sk;
          vsum[8 * d + 2 * c + e] = sv;
        }
      }
  }
}

// Every head's backward (head h's slices at column h D of every operand),
// in two passes over (head, 16-row tile) items with a block barrier after
// each; stats: 3 H Tq floats of shared memory. The first writes dq (row
// stride lddq) and the rows' stats:
template <int D>
__device__ void attention_bwd_dq(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                                 int ldk, int Tk, const bf16* dom, int ldd, int H, bf16* dq,
                                 int lddq, float* stats) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, qtiles = (Tq + 15) / 16;
  for (int item = warp; item < H * qtiles; item += nwarps) {
    const int h = item / qtiles, m0 = (item % qtiles) * 16, o = h * D;
    attn_bwd_dq_tile<D>(q + o, ldq, Tq, k + o, v + o, ldk, Tk, dom + o, ldd, m0, dq + o, lddq,
                        stats + 3 * h * Tq);
  }
  __syncthreads();
}

// The second writes dk and dv (row stride lddkv), and with kSums the fp32
// column sums of every 16-key tile's dk / dv rows into row j0 / 16 of ksum
// / vsum (row stride ldsum, head h at column h D); kSmQ: q and dom in
// shared memory.
template <int D, bool kSums = false, bool kSmQ = false>
__device__ void attention_bwd_dkv(const bf16* q, int ldq, int Tq, const bf16* k, const bf16* v,
                                  int ldk, int Tk, const bf16* dom, int ldd, int H, bf16* dk,
                                  bf16* dv, int lddkv, const float* stats, float* ksum = nullptr,
                                  float* vsum = nullptr, int ldsum = 0) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, ktiles = (Tk + 15) / 16;
  for (int item = warp; item < H * ktiles; item += nwarps) {
    const int h = item / ktiles, j0 = (item % ktiles) * 16, o = h * D;
    const size_t so = (size_t)(j0 / 16) * ldsum + o;
    attn_bwd_dkv_tile<D, kSums, kSmQ>(q + o, ldq, Tq, k + o, v + o, ldk, Tk, dom + o, ldd, j0,
                                      stats + 3 * h * Tq, dk + o, lddkv, dv + o, lddkv,
                                      kSums ? ksum + so : nullptr, kSums ? vsum + so : nullptr);
  }
  __syncthreads();
}

// Self-attention's backward over T rows given q | k | v rows (row stride
// ld) and dom (E columns, row stride ldd): dq | dk | dv into dqkv (row
// stride lddq). stats: 3 H T floats of shared memory. Ends with
// __syncthreads.
template <int D>
__device__ void attention_bwd(const bf16* qkv, int ld, const bf16* dom, int ldd, int T, int E,
                              int H, bf16* dqkv, int lddq, float* stats) {
  attention_bwd_dq<D>(qkv, ld, T, qkv + E, qkv + 2 * E, ld, T, dom, ldd, H, dqkv, lddq, stats);
  attention_bwd_dkv<D>(qkv, ld, T, qkv + E, qkv + 2 * E, ld, T, dom, ldd, H, dqkv + E,
                       dqkv + 2 * E, lddq, stats);
}

}  // namespace sd
