// Whole-chunk sampler with int8 context K/V: every step of the T-step DDIM /
// DPM-Solver++ chunk for a block of R robots in one thread-block cluster, in
// one launch, the cross-attention's products on the int8 tensor cores.
//
// Replaces soccerdiffusion_tpu/ops/fused_chunk.py: FusedChunkSampler.sample
// (_make_chunk_kernel) with context_kv_quant="int8" (kstat, group_robots=1),
// the JAX function step for step:
//   * per layer, the fp32 context K and V projections of the block's R
//     robots (not rounded to bf16) with one scale each, s = max(max|.| /
//     127, 1e-8) over the R robots' S x E values, stored as clip(rint(x /
//     s), +-127) in int8 (a true division, round half to even);
//   * per (step, layer), the R robots' bf16 cross queries with one scale
//     s_q over all of them, quantised alike;
//   * scores int32(q_q . k_q) x ((s_q s_k) / sqrt(D)) over the S context
//     keys; the step token's score s_x = (q . k_step) / sqrt(D) in fp32;
//     m = max(max s, s_x), p = exp(s - m), p_x = exp(s_x - m);
//   * o = int32(rint(127 p) . v_q) x (s_v / 127) + p_x v_step, divided by
//     sum p + p_x and rounded to bf16.
// Integer sums are exact, so the kernel and its plain version differ only
// where an fp32 value lands on the other side of a quantisation boundary.
// The rest of each decoder pass is decoder_pass.cuh's (the products, the
// self-attention, the MLP, the staged parameters).
//
// What is hard on a GPU: the scales couple the robots of a block. All R
// robots' K / V projections precede any quantisation, and all R robots'
// cross queries of a (step, layer) precede any of its scores: 1 + T L
// points where the R robots wait on each other (121 per ddim30 chunk at L =
// 4), while the bf16 kernel runs each robot alone. Design:
//   * a block of R <= 32 robots runs on one thread-block cluster of C <= 8
//     blocks (C the largest power of two that divides R), each block holding
//     R / C robots in turn; a block's 16 warps (8 at head_dim 128, with no
//     staged parameters, as the bf16 kernel's plan) work on one robot at a time,
//     whose state between the coupling points (the fp32 residual, the solver
//     carry, the bf16 cross queries: RobotState) lives in a global scratch
//     that the block alone writes and reads (L2-resident);
//   * each layer's pass is split at its cross queries: a segment runs, for
//     each of the block's robots, the cross-attention and MLP of layer l - 1
//     (with the scale of the last segment) and the self-attention and cross
//     queries of layer l, storing the queries and their max |q|; the block's
//     max goes into its shared memory and, after a cluster barrier, every
//     thread reads the C blocks' maxima through distributed shared memory
//     (two slots in turn, so that no block overwrites one a peer may still
//     read);
//   * the K / V scales: a first projection pass (mma.sync bf16, fp32 sums)
//     keeps only the max |x| of each (layer, K | V) per thread, reduced by
//     warp shuffles and shared-memory atomics, then across the cluster; a
//     second pass projects again and writes the int8 values in the order
//     of the integer mma fragments (kfrag8 / vfrag8). The projection is once
//     per chunk, so doing it twice costs little against the T passes;
//   * the products q_q k_q^T and rint(127 p) v_q run on mma.sync m16n8k32
//     s8 x s8 -> s32 (IMMA in SASS): a score tile's accumulators, quantised,
//     are the A fragment of the value product as they stand, the value
//     fragments being laid out for the key order that gives (vfrag8); a
//     head's int8 K or V (10 KB at h128, S=301) streams into a ring of
//     shared-memory buffers by one bulk copy (TMA) each, as in the bf16
//     kernel, and the warps split its keys in 32-key chunks with the scores
//     in registers; the warps' int32 partials are summed exactly.
// Bound on the H100: the int8 K/V scratch is half the bf16 one, (B, L, H, 2,
// Sk D) int8 with Sk = S rounded up to 32 (320 KB a robot at h128, S=301;
// T x that, 9.8 GB, read per B=1024 ddim30 chunk against the bf16 kernel's
// 19.7 GB), so its byte floor is half the bf16 kernel's; its operations are
// the bf16 kernel's with the cross-attention's at the int8 rate. What bounds
// it in this first form is the coupling: a block's robots run one after
// another, 1 + T L cluster barriers, and the state's round trips to L2.
#include "decoder_pass.cuh"

namespace sd {

struct Int8Args : PassArgs {
  const bf16* kv_t;     // (2 L E, E): row ((l H + h) 2 + sel) D + d, sel 0: wck, 1: wcv
  const bf16* kv_b;     // (2 L E) alike
  const float* noise;   // (B, P, J) fp32
  const bf16* context;  // (B, S, E)
  const bf16* stk;      // (T, L, E) per-step step-token cross K
  const bf16* stv;      // (T, L, E)
  const float* coef;    // (T, 5) [A, B, C, P, Q]
  int8_t* kv;           // scratch (B, L, H, 2, Sk D) int8 in integer-fragment order
  float* state;         // scratch (B, int8_state_floats) RobotState
  float* out;           // (B, P, J) fp32
  // optional record of the coupling (all null, or all set): per robot the
  // scales it used, (2 L) s_k, s_v per layer then (T, L) s_q per (step,
  // layer); per (robot, step, layer) its bf16 cross queries, their int8
  // form and the cross-attention's bf16 output, (B, T, L, P, E) each
  float* rec_scale;     // (B, 2 L + T L)
  bf16* rec_q;
  int8_t* rec_qq;
  bf16* rec_o;
  int T, Sk, R, C;
};

// threads of a block: 16 warps, or at head_dim 128 8 warps (up to 255
// registers a thread for its D = 128 accumulators, as the bf16 kernel's plan)
__host__ __device__ constexpr int int8_threads(int D) {
  return D == kWideHead ? kWideThreads : kPassThreads;
}
// int8 K / V units of the ring: the bf16 kernel's ring bytes hold twice as
// many at head_dim 32 / 64; two 40 KB units at head_dim 128 (S = 311)
__host__ __device__ constexpr int int8_ring(int D) { return D == 32 ? 8 : D == 64 ? 4 : 2; }

// fp32 floats of a robot's state between segments (ops/fused_chunk.py:
// int8_state_floats): the residual (P, E), x and x0cache (P, J), the cross
// queries (P, E) bf16
__host__ __device__ inline size_t int8_state_floats(int P, int E, int J) {
  return r4((size_t)P * E) + 2 * r4((size_t)P * J) + r4(((size_t)P * E + 1) / 2);
}

struct RobotState {
  float* h;
  float* x;
  float* x0c;
  bf16* q2;
};

__device__ inline RobotState robot_state(const Int8Args& a, int b) {
  RobotState s;
  s.h = a.state + (size_t)b * int8_state_floats(a.P, a.E, a.J);
  s.x = s.h + r4((size_t)a.P * a.E);
  s.x0c = s.x + r4((size_t)a.P * a.J);
  s.q2 = reinterpret_cast<bf16*>(s.x0c + r4((size_t)a.P * a.J));
  return s;
}

// Shared memory of a block (ops/fused_chunk.py:int8_smem_bytes): the ring's
// mbarriers, the fp32 residual, the chunk statistics, the warps' int32
// partials, the step-token scores (P, H), the rows' p_x and sums (2 P), the
// scales (the (layer, K | V) maxima and scales, 2 query maxima), the staged
// parameters (none at head_dim 128: read from L2 where used, as the bf16
// kernel's plan), the bf16 activations, the int8 queries (P, E + 16), the ring.
__host__ __device__ inline size_t int8_smem_bytes(int L, int P, int E, int H, int J, int Jp,
                                                  int Sk) {
  const int D = E / H;
  const size_t floats = r4((size_t)P * E) + Sk + (size_t)(int8_threads(D) / 32) * P * D +
                        r4((size_t)P * H) + r4(2 * (size_t)P) + r4(4 * (size_t)L + 2);
  const size_t halves = (staged_params(D) ? (size_t)chunk_param_elems(L, E, P, J) : 0) +
                        (size_t)P * (E + 8) + (size_t)P * (3 * E + 8) + (size_t)P * (Jp + 8);
  return 64 + 4 * floats + 2 * halves + (size_t)P * (E + 16) + (size_t)int8_ring(D) * Sk * D;
}

struct Int8Smem {
  uint64_t* bars;  // 8 mbarriers
  float* h;        // (P, E) fp32 residual of the robot in hand
  float* red;      // (Sk / 32, 16, 2) chunk statistics of a head
  int* part;       // (warps, P, D) int32 value partials
  float* sx;       // (P, H) step-token scores
  float* rows;     // (P, 2) p_x and the sum of a head's rows
  float* kvmax;    // (2 L) max |K|, |V| of the block's robots per layer (float bits, atomics)
  float* kvscale;  // (2 L) s_k, s_v per layer
  float* qmax;     // 2 slots: max |q2| of the block's robots in a segment
  bf16* params;    // the staged parameters (stage_params)
  bf16* act;       // (P, E + 8)
  bf16* wide;      // (P, 3E + 8)
  bf16* xin;       // (P, Jp + 8)
  int8_t* qq;      // (P, E + 16) int8 queries
  int8_t* ring;    // int8_ring(D) units of Sk D
};

template <int D>
__device__ inline Int8Smem carve_int8_smem(float4* base, const Int8Args& a) {
  Int8Smem s;
  const int P = a.P, E = a.E;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.h = reinterpret_cast<float*>(s.bars + 8);
  s.red = s.h + r4((size_t)P * E);
  s.part = reinterpret_cast<int*>(s.red + a.Sk);
  s.sx = reinterpret_cast<float*>(s.part + (size_t)(int8_threads(D) / 32) * P * D);
  s.rows = s.sx + r4((size_t)P * a.H);
  s.kvmax = s.rows + r4(2 * (size_t)P);
  s.kvscale = s.kvmax + 2 * a.L;
  s.qmax = s.kvscale + 2 * a.L;
  s.params = reinterpret_cast<bf16*>(s.kvmax + r4(4 * (size_t)a.L + 2));
  s.act = s.params + (staged_params(D) ? chunk_param_elems(a.L, E, P, a.J) : 0);
  s.wide = s.act + (size_t)P * (E + 8);
  s.xin = s.wide + (size_t)P * (3 * E + 8);
  s.qq = reinterpret_cast<int8_t*>(s.xin + (size_t)P * (a.Jp + 8));
  s.ring = s.qq + (size_t)P * (E + 16);
  return s;
}

// c += a . b on one m16n8k32 s8 tile, int32 sums
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte of element (key s, dim d) of a head's int8 K in score-fragment order:
// per 8-key tile, lane 4 g + c holds key g's dims 32 kd + 4c .. + 3 and 32 kd
// + 16 + 4c .. + 3 of every k32 step kd (the B fragment of m16n8k32), D / 16
// words in a row.
__host__ __device__ inline int kfrag8(int s, int d, int D) {
  const int dd = d & 31;
  const int lane = 4 * (s & 7) + ((dd & 15) >> 2);
  const int reg = 2 * (d >> 5) + (dd >> 4);
  return (((s >> 3) * 32 + lane) * (D / 16) + reg) * 4 + (d & 3);
}

// Byte of element (key s, dim d) of a head's int8 V in value-fragment order:
// per 32-key chunk, lane 4 g + c holds dim 8 n + g of the keys that its
// score accumulators hold, in the order in which they become its A fragment
// of m16n8k32: byte i of word 2 n + half is key 16 half + 8 (i >> 1) + 2c +
// (i & 1); D / 4 words in a row.
__host__ __device__ inline int vfrag8(int s, int d, int D) {
  const int kk = s & 31, w = kk & 15;
  const int lane = 4 * (d & 7) + ((w & 7) >> 1);
  const int reg = 2 * (d >> 3) + (kk >> 4);
  const int byte = 2 * (w >> 3) + (w & 1);
  return (((s >> 5) * 32 + lane) * (D / 4) + reg) * 4 + byte;
}

template <class T>
__device__ __forceinline__ T* peer_of(T* p, unsigned rank) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(q);
}

// the block's robots wait on each other: the block's barrier, or its cluster's
__device__ __forceinline__ void block_sync(int C) {
  if (C > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// the max over the cluster's C blocks of slot p of their shared memory (the
// cluster runs along x: a block's rank is blockIdx.x % C)
__device__ __forceinline__ float cluster_max(float* p, int C) {
  float m = *p;
  for (int r = 1; r < C; ++r) m = fmaxf(m, *peer_of(p, (unsigned)((blockIdx.x + r) % C)));
  return m;
}

// the warp's max of v into *slot (non-negative floats order as their bits)
__device__ __forceinline__ void warp_max_into(float v, float* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) atomicMax(reinterpret_cast<int*>(slot), __float_as_int(v));
}

__device__ __forceinline__ int8_t quantise8(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

struct KvAmaxEpi {  // the per-thread max |K|, |V| of a layer's projection
  float* mk;
  float* mv;
  int D;
  __device__ void operator()(int, int n, float v) const {
    float* m = ((n / D) & 1) ? mv : mk;
    *m = fmaxf(*m, fabsf(v));
  }
};

struct KvQuantEpi {  // projected column n of context row m -> int8 in the scratch
  int8_t* kv;        // the robot's layer (H, 2, Sk D)
  int D, Sk;
  float sk, sv;
  __device__ void operator()(int m, int n, float v) const {
    const int d = n % D, u = n / D;  // u = 2 h + sel
    int8_t* blk = kv + (size_t)u * Sk * D;
    blk[(u & 1) ? vfrag8(m, d, D) : kfrag8(m, d, D)] = quantise8(v, (u & 1) ? sv : sk);
  }
};

// The int8 cross-attention of the P rows of one robot over its S context
// keys and the step token, all H heads in turn: q the bf16 queries (ldq),
// qq the int8 queries (ldqq bytes), kv the stream of the robot's layer
// units (K of head h unit 2h, V 2h + 1; the first int8_ring(D) issued),
// qk = s_q s_k / sqrt(D), vs = s_v / 127, stk / stv the layer's step-token
// rows; sm.sx holds the step-token scores (P, H). The heads' outputs,
// rounded to bf16, go to out (ldo). Two block barriers a head.
template <int D>
__device__ void int8_cross_attention(const int8_t* qq, int ldqq, KvStream<D, false, int8_t>& kv,
                                     int P, int H, int S, float qk, float vs, const bf16* stv,
                                     const Int8Smem& sm, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3, nch = kv.Sp / 32, nparts = min(nch, nwarps);
  const int rlo = min(g, P - 1), rhi = min(g + 8, P - 1);
  for (int h = 0; h < H; ++h) {
    // the A fragments of the head's int8 queries (rows past P repeat row P - 1)
    uint32_t qa[D / 32][4];
#pragma unroll
    for (int kd = 0; kd < D / 32; ++kd) {
      const int8_t* q0 = qq + (size_t)rlo * ldqq + h * D + 32 * kd + 4 * c;
      const int8_t* q1 = qq + (size_t)rhi * ldqq + h * D + 32 * kd + 4 * c;
      qa[kd][0] = *reinterpret_cast<const uint32_t*>(q0);
      qa[kd][1] = *reinterpret_cast<const uint32_t*>(q1);
      qa[kd][2] = *reinterpret_cast<const uint32_t*>(q0 + 16);
      qa[kd][3] = *reinterpret_cast<const uint32_t*>(q1 + 16);
    }
    kv.wait(2 * h);
    __syncthreads();  // the head's K has landed; the last head's partials are summed
    const int8_t* kh = kv.buffer(2 * h);
    // pass 1: this warp's chunks, scores kept in registers, their statistics
    float s[kMaxChunks][4][4];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = warp + i * nwarps;
      if (ch >= nch) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(kh + ((size_t)(4 * ch + j) * 32 + lane) * (D / 4));
        uint32_t kr[D / 16];
#pragma unroll
        for (int u = 0; u < D / 16; ++u) kr[u] = w[u];
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kd = 0; kd < D / 32; ++kd) {
          const uint32_t b[2] = {kr[2 * kd], kr[2 * kd + 1]};
          mma_s8(acc, qa[kd], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 32 * ch + 8 * j + 2 * c + (e & 1);
          s[i][j][e] = key < S ? (float)acc[e] * qk : -INFINITY;
        }
      }
      chunk_stats(s[i], sm.red, ch);
    }
    kv.wait(2 * h + 1);
    __syncthreads();  // the head's V has landed; its K is consumed; the statistics are in
    kv.issue();       // the unit after the ring's into K's buffer
    // the rows' max and sum with the step token's column
    float mx[2], den[2], px[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* st = sm.red + 2 * (g + 8 * hh);
      float m = -INFINITY;
      for (int ch = c; ch < nch; ch += 4) m = fmaxf(m, st[32 * ch]);
      const float sxr = sm.sx[(hh ? rhi : rlo) * H + h];
      m = fmaxf(quad_max(m), sxr);
      float l = 0.f;
      for (int ch = c; ch < nch; ch += 4) l += st[32 * ch + 1] * expf(st[32 * ch] - m);
      mx[hh] = m;
      px[hh] = expf(sxr - m);
      den[hh] = quad_sum(l) + px[hh];
    }
    // pass 2: rint(127 p) v_q over the warp's chunks, int32 sums
    const int8_t* vh = kv.buffer(2 * h + 1);
    int o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = warp + i * nwarps;
      if (ch >= nch) break;
      uint32_t pq[4][4];  // [tile j][e]: rint(127 exp(s - m)), 0 .. 127
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pq[j][e] = (uint32_t)(int)rintf(expf(s[i][j][e] - mx[e >> 1]) * 127.f);
      const auto pack = [](uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
        return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
      };
      const uint32_t pa[4] = {pack(pq[0][0], pq[0][1], pq[1][0], pq[1][1]),
                              pack(pq[0][2], pq[0][3], pq[1][2], pq[1][3]),
                              pack(pq[2][0], pq[2][1], pq[3][0], pq[3][1]),
                              pack(pq[2][2], pq[2][3], pq[3][2], pq[3][3])};
      const uint4* vc = reinterpret_cast<const uint4*>(vh + ((size_t)ch * 32 + lane) * D);
      uint4 vr[D / 16];
#pragma unroll
      for (int u = 0; u < D / 16; ++u) vr[u] = vc[u];
      const uint32_t* w = reinterpret_cast<const uint32_t*>(vr);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const uint32_t b[2] = {w[2 * n], w[2 * n + 1]};
        mma_s8(o[n], pa, b);
      }
    }
    if (warp < nparts) {
      int* pw = sm.part + (size_t)warp * P * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        if (r >= P) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          pw[r * D + 8 * n + 2 * c] = o[n][2 * hh];
          pw[r * D + 8 * n + 2 * c + 1] = o[n][2 * hh + 1];
        }
      }
    }
    if (warp == 0 && c == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        if (r < P) {
          sm.rows[2 * r] = px[hh];
          sm.rows[2 * r + 1] = den[hh];
        }
      }
    }
    __syncthreads();  // V is consumed; the partials are in
    kv.issue();       // the next unit into V's buffer
    for (int i = threadIdx.x; i < P * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      int acc = 0;
      for (int w = 0; w < nparts; ++w) acc += sm.part[((size_t)w * P + r) * D + d];
      float v = (float)acc * vs;
      v = v + sm.rows[2 * r] * tof(stv[h * D + d]);
      out[(size_t)r * ldo + h * D + d] = __float2bfloat16(v / sm.rows[2 * r + 1]);
    }
  }
}

template <int D, int KC>
__global__ void __launch_bounds__(int8_threads(D)) fused_chunk_int8_kernel(Int8Args a) {
  extern __shared__ float4 smem4[];
  const Int8Smem sm = carve_int8_smem<D>(smem4, a);
  const int C = a.C, NR = a.R / C;
  const int b0 = (blockIdx.x / C) * a.R + (blockIdx.x % C) * NR;  // the block's first robot
  const int L = a.L, H = a.H, E = 32 * KC, P = a.P, J = a.J, S = a.S, Sk = a.Sk;
  const int lda = E + 8, ldw = 3 * E + 8, ldx = a.Jp + 8, ldq = E + 16;
  const size_t EE = (size_t)E * E, unit = (size_t)Sk * D;
  // layer l's tensor k (per-layer width w): staged, or at head_dim 128 in global memory
  auto prm = [&](ChunkParam k, int l, int w) -> const bf16* {
    if constexpr (staged_params(D)) {
      return sm.params + chunk_param_offset(k, L, E, P) + l * w;
    } else {
      return param_src(a, k) + l * w;
    }
  };
  init_kv_ring(sm.bars, int8_ring(D));
  if constexpr (staged_params(D)) stage_params(a, sm.params);
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x) sm.kvmax[i] = 0.f;
  __syncthreads();

  // once per chunk: the block's max |K|, |V| per layer over its robots'
  // fp32 projections, then the cluster's
  for (int l = 0; l < L; ++l) {
    float mk = 0.f, mv = 0.f;
    for (int i = 0; i < NR; ++i)
      mma_dense_rows<2, 4>(a.context + (size_t)(b0 + i) * S * E, E, S, E, a.kv_t + 2 * l * EE, E,
                           2 * E, a.kv_b + 2 * l * E, KvAmaxEpi{&mk, &mv, D});
    warp_max_into(mk, sm.kvmax + 2 * l);
    warp_max_into(mv, sm.kvmax + 2 * l + 1);
  }
  block_sync(C);
  for (int i = threadIdx.x; i < 2 * L; i += blockDim.x)
    sm.kvscale[i] = fmaxf(cluster_max(sm.kvmax + i, C) / 127.f, 1e-8f);
  __syncthreads();
  // the int8 K/V of the block's robots in fragment order, and their state
  for (int i = 0; i < NR; ++i) {
    const int b = b0 + i;
    for (int l = 0; l < L; ++l)
      mma_dense_rows<2, 4>(a.context + (size_t)b * S * E, E, S, E, a.kv_t + 2 * l * EE, E, 2 * E,
                           a.kv_b + 2 * l * E,
                           KvQuantEpi{a.kv + ((size_t)b * L + l) * H * 2 * unit, D, Sk,
                                      sm.kvscale[2 * l], sm.kvscale[2 * l + 1]});
    const RobotState st = robot_state(a, b);
    for (int k = threadIdx.x; k < P * J; k += blockDim.x) {
      st.x[k] = a.noise[(size_t)b * P * J + k];
      st.x0c[k] = 0.f;
    }
    if (a.rec_scale)
      for (int k = threadIdx.x; k < 2 * L; k += blockDim.x)
        a.rec_scale[(size_t)b * (2 + a.T) * L + k] = sm.kvscale[k];
  }
  // the scratch's writes before the bulk copies (the async proxy) read it
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncthreads();

  unsigned kv_seq = 0;  // K / V units this block has streamed
  int seg = 0;          // segments that ended in a query scale
  float sq = 0.f;       // the last such scale
  const float scale = attn_scale<D>();
  for (int t = 0; t < a.T; ++t) {
    const float* cf = a.coef + 5 * t;
    for (int k = 0; k <= L; ++k) {
      // segment k of the step, for each robot: [layer k - 1's cross-attention
      // and MLP] [layer k's self-attention and cross queries | the output]
      float* qslot = sm.qmax + (seg & 1);
      if (k < L && threadIdx.x == 0) *qslot = 0.f;
      for (int i = 0; i < NR; ++i) {
        const int b = b0 + i;
        const RobotState st = robot_state(a, b);
        __syncthreads();  // the last robot's shared memory is read
        if (k == 0) {
          for (int m = threadIdx.x; m < P * a.Jp; m += blockDim.x) {
            const int r = m / a.Jp, j = m % a.Jp;
            sm.xin[r * ldx + j] = __float2bfloat16(j < J ? st.x[r * J + j] : 0.f);
          }
          __syncthreads();
          embed_product(sm.xin, ldx, P, a.Jp, a.emb_t, E, prm(kEmbB, 0, 0),
                        EmbedEpi{sm.h, prm(kPe, 0, 0), E});
          __syncthreads();
        } else {
          const int l = k - 1;
          const bf16* stk = a.stk + ((size_t)t * L + l) * E;
          const bf16* stv = a.stv + ((size_t)t * L + l) * E;
          KvStream<D, false, int8_t> kvs{a.kv + ((size_t)b * L + l) * H * 2 * unit, sm.ring,
                                         sm.bars, Sk, int8_ring(D), 2 * H, 0, kv_seq};
          kv_seq += kvs.units;
          for (int u = 0; u < kvs.nb; ++u) kvs.issue();
          const size_t rec = (((size_t)b * a.T + t) * L + l) * P * E;  // the record's (b, t, l)
          for (int m = threadIdx.x; m < P * E; m += blockDim.x) {
            sm.h[m] = st.h[m];
            const float q = tof(st.q2[m]);
            const int8_t qi = quantise8(q, sq);
            sm.wide[(m / E) * ldw + m % E] = st.q2[m];
            sm.qq[(m / E) * ldq + m % E] = qi;
            if (a.rec_scale) {
              a.rec_q[rec + m] = st.q2[m];
              a.rec_qq[rec + m] = qi;
            }
          }
          if (a.rec_scale && threadIdx.x == 0)
            a.rec_scale[(size_t)b * (2 + a.T) * L + 2 * L + t * L + l] = sq;
          __syncthreads();
          for (int m = threadIdx.x; m < P * H; m += blockDim.x) {
            const int r = m / H, hh = m % H;
            float acc = 0.f;
            for (int d = 0; d < D; ++d)
              acc += tof(sm.wide[r * ldw + hh * D + d]) * tof(stk[hh * D + d]);
            sm.sx[m] = acc * scale;
          }
          // the step-token scores are read after the first barrier inside
          int8_cross_attention<D>(sm.qq, ldq, kvs, P, H, S, sq * sm.kvscale[2 * l] * scale,
                                  sm.kvscale[2 * l + 1] * (1.f / 127.f), stv, sm, sm.act, lda);
          __syncthreads();
          if (a.rec_scale)
            for (int m = threadIdx.x; m < P * E; m += blockDim.x)
              a.rec_o[rec + m] = sm.act[(m / E) * lda + m % E];
          rows_product<KC>(sm.act, lda, P, a.co_t + l * EE, E, prm(kCoB, l, E), AddTo{sm.h, E});
          __syncthreads();
          const bf16* ln_s = prm(kLnS, l, 3 * E);
          const bf16* ln_b = prm(kLnB, l, 3 * E);
          ln_bf16_rows(sm.h, P, E, ln_s + 2 * E, ln_b + 2 * E, sm.act, lda);
          __syncthreads();
          rows_product<KC>(sm.act, lda, P, a.m1_t + l * EE, E, prm(kM1B, l, E),
                           GeluBf16<kGeluExact>{sm.wide, ldw});
          __syncthreads();
          rows_product<KC>(sm.wide, ldw, P, a.m2_t + l * EE, E, prm(kM2B, l, E), AddTo{sm.h, E});
          __syncthreads();
        }
        if (k < L) {
          // layer k's self-attention, then its cross queries: to the state,
          // their max |q| to the segment's slot
          const bf16* ln_s = prm(kLnS, k, 3 * E);
          const bf16* ln_b = prm(kLnB, k, 3 * E);
          ln_bf16_rows(sm.h, P, E, ln_s, ln_b, sm.act, lda);
          __syncthreads();
          rows_product<KC>(sm.act, lda, P, a.qkv_t + k * 3 * EE, 3 * E, prm(kQkvB, k, 3 * E),
                           StoreRoundBf16{sm.wide, ldw});
          __syncthreads();
          chunk_self_attention<D>(sm.wide, ldw, P, E, H, sm.act, lda);
          __syncthreads();
          rows_product<KC>(sm.act, lda, P, a.so_t + k * EE, E, prm(kSoB, k, E), AddTo{sm.h, E});
          __syncthreads();
          ln_bf16_rows(sm.h, P, E, ln_s + E, ln_b + E, sm.act, lda);
          __syncthreads();
          rows_product<KC>(sm.act, lda, P, a.cq_t + k * EE, E, prm(kCqB, k, E),
                           StoreRoundBf16{sm.wide, ldw});
          __syncthreads();
          float mq = 0.f;
          for (int m = threadIdx.x; m < P * E; m += blockDim.x) {
            const bf16 q = sm.wide[(m / E) * ldw + m % E];
            st.q2[m] = q;
            mq = fmaxf(mq, fabsf(tof(q)));
            st.h[m] = sm.h[m];
          }
          warp_max_into(mq, qslot);
        } else {
          // the output product of the bf16 residual, the solver update in its epilogue
          for (int m = threadIdx.x; m < P * E; m += blockDim.x)
            sm.act[(m / E) * lda + m % E] = __float2bfloat16(sm.h[m]);
          __syncthreads();
          rows_product<KC>(sm.act, lda, P, a.fc_t, J, prm(kFcB, 0, 0),
                           SolverEpi{st.x, st.x0c, sm.xin, J, ldx, cf[0], cf[1], cf[2], cf[3],
                                     cf[4]});
        }
      }
      if (k < L) {
        // the R robots' queries of (t, k) are in: their scale
        block_sync(C);
        sq = fmaxf(cluster_max(qslot, C) / 127.f, 1e-8f);
        ++seg;
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < NR; ++i) {
    const RobotState st = robot_state(a, b0 + i);
    for (int m = threadIdx.x; m < P * J; m += blockDim.x) a.out[(size_t)(b0 + i) * P * J + m] = st.x[m];
  }
  block_sync(C);  // no block leaves while a peer may read its shared memory
}

}  // namespace sd

// ptrs: the 19 PassArgs weight pointers (declaration order: emb_t ..
//       fc_b), kv_t, kv_b, noise, context, stk, stv, coef, int8 kv scratch,
//       state scratch, out, and the record (rec_scale, rec_q, rec_qq, rec_o:
//       all null, or all set)
// ints: L, E, H, P, J, Jp, B, S, Sk, T, R (robots a block, dividing B, <= 32),
//       C (blocks a cluster: a power of two <= 8 dividing R); head_dim 32 / 64
//       at hidden 128 / 256, or 128 at hidden 512 (larger_model)
extern "C" int sd_fused_chunk_int8(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  Int8Args a;
  const bf16** w = &a.emb_t;
  for (int i = 0; i < kPassWeights; ++i) w[i] = static_cast<const bf16*>(ptrs[i]);
  a.kv_t = static_cast<const bf16*>(ptrs[19]);
  a.kv_b = static_cast<const bf16*>(ptrs[20]);
  a.noise = static_cast<const float*>(ptrs[21]);
  a.context = static_cast<const bf16*>(ptrs[22]);
  a.stk = static_cast<const bf16*>(ptrs[23]);
  a.stv = static_cast<const bf16*>(ptrs[24]);
  a.coef = static_cast<const float*>(ptrs[25]);
  a.kv = static_cast<int8_t*>(const_cast<void*>(ptrs[26]));
  a.state = static_cast<float*>(const_cast<void*>(ptrs[27]));
  a.out = static_cast<float*>(const_cast<void*>(ptrs[28]));
  a.rec_scale = static_cast<float*>(const_cast<void*>(ptrs[29]));
  a.rec_q = static_cast<bf16*>(const_cast<void*>(ptrs[30]));
  a.rec_qq = static_cast<int8_t*>(const_cast<void*>(ptrs[31]));
  a.rec_o = static_cast<bf16*>(const_cast<void*>(ptrs[32]));
  a.L = ints[0];
  a.E = ints[1];
  a.H = ints[2];
  a.P = ints[3];
  a.J = ints[4];
  a.Jp = ints[5];
  a.B = ints[6];
  a.S = ints[7];
  a.Sk = ints[8];
  a.T = ints[9];
  a.R = ints[10];
  a.C = ints[11];
  a.Sp = a.Sk;
  a.nbuf = 0;
  const int D = pass_head_dim(a.E, a.H), threads = int8_threads(D);
  const bool hidden = D == kWideHead ? a.E == 512 : a.E == 128 || (a.E == 256 && D == 64);
  const bool shape = D != 0 && hidden && a.P >= 1 && a.P <= 16 && (a.Jp == 32 || a.Jp == 64) &&
                     a.Jp >= a.J && a.J % 2 == 0 && a.S >= 1 && a.Sk == (a.S + 31) / 32 * 32 &&
                     a.Sk <= 32 * kMaxChunks * (threads / 32) && a.R >= 1 && a.R <= 32 &&
                     a.B % a.R == 0 && (a.C == 1 || a.C == 2 || a.C == 4 || a.C == 8) &&
                     a.R % a.C == 0 &&
                     (a.rec_scale ? a.rec_q && a.rec_qq && a.rec_o
                                  : !a.rec_q && !a.rec_qq && !a.rec_o);
  if (!shape) return (int)cudaErrorInvalidValue;
  void (*kernel)(Int8Args) = D == 32          ? fused_chunk_int8_kernel<32, 4>
                             : D == kWideHead ? fused_chunk_int8_kernel<128, 16>
                             : a.E == 128     ? fused_chunk_int8_kernel<64, 4>
                                              : fused_chunk_int8_kernel<64, 8>;
  const size_t smem = int8_smem_bytes(a.L, a.P, a.E, a.H, a.J, a.Jp, a.Sk);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B / a.R) * a.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int8 kernel's shared memory (int8_smem_bytes), exported so that its
// Python mirror (ops/fused_chunk.py:int8_smem_bytes, which the wrapper's
// shape check uses) can be held equal to it.
// ints: L, P, E, H, J, Jp, Sk
extern "C" long long sd_int8_smem_bytes(const int* ints) {
  return (long long)sd::int8_smem_bytes(ints[0], ints[1], ints[2], ints[3], ints[4], ints[5],
                                        ints[6]);
}
