// Whole-chunk sampler: every step of the T-step DDIM / DPM-Solver++ chunk
// for one robot in one thread block, in one launch, on the tensor cores.
//
// Replaces soccerdiffusion_tpu/ops/fused_chunk.py: FusedChunkSampler.sample
// (_make_chunk_kernel), its default "kstat", group_robots=1, unquantised
// form.
//
// Instances for head_dim 32 (h128) and 64 (E=128 or 256, the vit_flagship
// model at 256), templated on the head dim and on E / 32.
//
// Bound on the H100: the context K/V of one robot (L x 2 x S x E bf16 =
// 616 KB at L=4, S=301, E=128; 1.27 MB at S=311, E=256) do not fit in the
// 227 KB of shared memory the TPU kernel's VMEM scratch held them in, and at
// B=1024 the set is 631 MB, beyond the 50 MB L2. So the block projects them
// once per chunk into a global scratch (allocated by the wrapper) and reads
// them again at each step: T x 616 KB per robot, ~19 GB per B=1024 chunk, a
// 5.6 ms floor at 3.35 TB/s (HBM). The decoder weights (1 MB at h128, 4 MB
// at E=256) are read from L2 once per robot and step, and each of the 30 x L
// layer passes is a chain of small dependent phases over 10 rows: what bounds
// the kernel now is that chain's latency per robot (L2 round trips, block
// barriers) and, at E=256, the L2-to-SM rate of the weights (~20 bytes a
// cycle an SM; tools/chunk_phase_clock.py, PERF.md). The first port did
// every product as scalar fp32 FMAs (67.6 ms at h128 B=1024, 36.6 ms at
// head_dim 64 B=64 on an H100 80GB HBM3 at 700 W). Design:
//   * every product on the tensor cores (mma.sync m16n8k16 bf16, mma.cuh):
//     the once-per-chunk K/V projection (mma_dense_rows, 32 x 32 warp
//     items over the context rows) and the 10-row products of every pass
//     (rows_product: A from shared memory, the serving weights packed once
//     per sampler, transposed (out, in), each warp issuing all its 16-byte
//     weight loads of a round before its products); the LayerNorm
//     parameters and biases staged in shared memory once per chunk;
//   * the projection writes each (layer, head)'s K and V in the order of
//     the mma fragments that read them (kfrag / vfrag): a lane's B fragments
//     of an 8-key score tile (or a 16-key value tile) are one or two 16-byte
//     loads, conflict-free from shared memory;
//   * the cross-attention streams its K / V units (one head's K or V, 20 KB
//     at h128, 41 KB at E=256) from the scratch into a ring of 2-4
//     shared-memory buffers, each unit one bulk copy (TMA) issued by one
//     thread and completing on the buffer's mbarrier: the layer's first
//     units at the layer's start (during its self-attention), each later
//     one as soon as a buffer is consumed;
//     per head the warps split the keys in 32-key chunks with the scores in
//     registers, write each chunk's row max and sum of exp, merge them in
//     chunk order, round the normalised P to bf16 (the plain version's
//     rounding point) and sum the warps' fp32 partials in order (two heads
//     at a time where the ring holds their four units);
//   * the step-token key and value (shared by all robots, changing with t)
//     are key S of every layer: the block writes them into its scratch at
//     the start of each step, so they enter the same softmax as column S;
//     keys past S are zero and score -inf;
//   * the solver update runs in the output product's epilogue, which also
//     writes the next step's bf16 embedding input;
//   * 16 warps per robot (128 registers a thread: one block on an SM) while
//     the card has an SM per robot; past that, at head_dim 32, 8 warps, two
//     blocks on an SM (ops/fused_chunk.py:block_threads);
//   * while the card has two SMs per robot (B <= 66 on 132 SMs), a cluster
//     of two blocks per robot (CS = 2, ops/fused_chunk.py:cluster_size):
//     each projects and attends over half of the heads, so that each
//     streams half of the context K/V, and writes its heads' output into
//     both blocks' shared memory (distributed shared memory, one of two
//     buffers in turn) before one cluster barrier; both run the rest of the
//     pass alike (measured on an H100 80GB HBM3 at 700 W: h128 B=64 3.85 ->
//     3.00 ms, head_dim 64 B=64 7.73 -> 6.92 ms; PERF.md).
// Block barriers per decoder pass at L=4: 71 at head_dim 32 with 16 warps
// (1 + 17 per layer, 6 of them in the cross-attention, + 2), 95 with one
// head at a time (head_dim 64, or 8 warps: 1 + 23 per layer + 2); with a
// 2-block cluster 59 at head_dim 32 (1 + 14 per layer + 2) and 71 at head_dim
// 64 (1 + 17 per layer + 2), a cluster barrier in each layer among them; the
// first port had 56, over phases several times longer.
// Shared memory (chunk_smem_bytes): 137 KB at h128 (P=10, J=20, S=301; 87 KB
// with 8 warps, 142 KB in a cluster), 189 KB at E=256, S=311 (199 KB in a
// cluster). The x / x0cache solver carry and
// the fp32 residual stay in shared memory across the T steps; the (T, 5)
// [A, B, C, P, Q] table drives DDIM (C = 0) and DPM-Solver++(2M) with one
// update rule.
#include "encoder_layer.cuh"

namespace sd {

struct ChunkArgs {
  // the serving weights, bf16, Dense kernels transposed (out, in), per-layer
  // tensors stacked on a leading L axis (ops/fused_chunk.py:kernel_weights)
  const bf16* emb_t;  // (E, Jp): columns J .. Jp - 1 zero
  const bf16* emb_b;  // (E)
  const bf16* pe;     // (P, E) sinusoidal table
  const bf16* qkv_t;  // (L, 3E, E) self-attention q | k | v
  const bf16* qkv_b;  // (L, 3E)
  const bf16* so_t;   // (L, E, E)
  const bf16* so_b;
  const bf16* cq_t;
  const bf16* cq_b;
  const bf16* co_t;
  const bf16* co_b;
  const bf16* m1_t;
  const bf16* m1_b;
  const bf16* m2_t;
  const bf16* m2_b;
  const bf16* ln_s;   // (L, 3, E) norm1 / norm2 / norm3
  const bf16* ln_b;
  const bf16* fc_t;   // (J, E)
  const bf16* fc_b;   // (J)
  const bf16* kv_t;   // (2 L E, E): row ((l H + h) 2 + sel) D + d, sel 0: wck, 1: wcv
  const bf16* kv_b;   // (2 L E) alike
  const float* noise;   // (B, P, J) fp32
  const bf16* context;  // (B, S, E)
  const bf16* stk;      // (T, L, E) per-step step-token cross K
  const bf16* stv;      // (T, L, E)
  const float* coef;    // (T, 5) [A, B, C, P, Q]
  bf16* kv;             // scratch (B, L, H, 2, Sp D) in fragment order
  float* out;           // (B, P, J) fp32
  int L, E, H, P, J, Jp, B, S, Sp, T;
  int nbuf;             // K / V units in the cross-attention's ring (2 .. 4)
};

constexpr int kChunkThreads = 512;

// most 32-key chunks a warp scores per head (its scores stay in registers):
// S + 1 <= 32 kMaxChunks x 16 warps keys
constexpr int kMaxChunks = 2;

// K / V units (one head's Sp x D keys of K or of V) in the cross-attention's
// ring of shared-memory buffers: 4 at head_dim 32 with 16 warps (20 KB
// each at S=301), else 2 (two 41 KB units at head_dim 64; two blocks of 8
// warps on an SM at head_dim 32)
__host__ __device__ inline int kv_buffers(int D, int threads) {
  return D == 32 && threads == kChunkThreads ? 4 : 2;
}

// Index of element (key s, dim d) of a head's K in score-fragment order:
// per 8-key tile, lane 4 g + c holds the B fragments of key g, dims
// (2c, 2c+1, 2c+8, 2c+9) of every k16 step, D / 8 words in a row.
__host__ __device__ inline int kfrag(int s, int d, int D) {
  const int dd = d & 15;
  const int lane = 4 * (s & 7) + ((dd & 7) >> 1);
  const int reg = 2 * (d >> 4) + (dd >> 3);
  return (((s >> 3) * 32 + lane) * (D / 8) + reg) * 2 + (dd & 1);
}

// Index of element (key s, dim d) of a head's V in value-fragment order:
// per 16-key tile, lane 4 g + c holds the B fragments of dim 8 n + g, keys
// (2c, 2c+1, 2c+8, 2c+9), for every n8 tile n, D / 4 words in a row.
__host__ __device__ inline int vfrag(int s, int d, int D) {
  const int kk = s & 15;
  const int lane = 4 * (d & 7) + ((kk & 7) >> 1);
  const int reg = 2 * (d >> 3) + (kk >> 3);
  return (((s >> 4) * 32 + lane) * (D / 4) + reg) * 2 + (kk & 1);
}

struct KvFragEpi {  // projected column n of context row m -> the scratch
  bf16* kv;
  int D, Sp, lhs0;
  __device__ void operator()(int m, int n, float v) const {
    const int d = n % D, lhs = lhs0 + n / D;  // lhs = (l H + h) 2 + sel
    bf16* blk = kv + (size_t)lhs * Sp * D;
    blk[(lhs & 1) ? vfrag(m, d, D) : kfrag(m, d, D)] = __float2bfloat16(v);
  }
};

struct SolverEpi {  // eps(m, n) -> the solver update of x, x0c and the next bf16 input
  float* x;
  float* x0c;
  bf16* xin;
  int J, Jp;
  float cA, cB, cC, cP, cQ;
  __device__ void operator()(int m, int n, float eps) const {
    const int i = m * J + n;
    const float xi = x[i];
    const float xn = cA * xi + cB * eps + cC * x0c[i];
    x[i] = xn;
    x0c[i] = cP * xi + cQ * eps;
    xin[m * Jp + n] = __float2bfloat16(xn);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// every thread of the block's cluster arrives and waits (release / acquire:
// the cluster's shared-memory writes before it are seen after it)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// the barrier of a robot's blocks: the block's, or its cluster's
__device__ __forceinline__ void robot_sync(int cs) {
  if (cs > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// p, an address in this block's shared memory, in block `rank` of its cluster
__device__ __forceinline__ bf16* cluster_peer(bf16* p, unsigned rank) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<bf16*>(q);
}

// The cross-attention's K / V stream of one layer: unit u = 2 h + sel is head
// h's K (sel 0) or V (sel 1), Sp x D bf16 contiguous in the scratch
// (fragment order), copied by one bulk copy (TMA, cp.async.bulk) into
// buffer G % nb of the ring, G = seq0 + u counting the block's units over
// every layer and step, with completion on that buffer's mbarrier (phase
// parity G / nb & 1). Thread 0 issues; every thread keeps the same count.
template <int D>
struct KvStream {
  const bf16* kvl;  // the layer's (H, 2, Sp D) scratch
  bf16* ring;       // nb buffers of Sp D
  uint64_t* bars;   // nb mbarriers
  int Sp, nb, units, issued;
  unsigned seq0;

  __device__ const bf16* buffer(int u) const { return ring + (size_t)((seq0 + u) % nb) * Sp * D; }
  // issue the next unit, if any
  __device__ void issue() {
    if (issued < units && threadIdx.x == 0) {
      const unsigned G = seq0 + issued;
      const uint32_t bar = smem_addr(bars + G % nb), bytes = (uint32_t)(Sp * D * sizeof(bf16));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(buffer(issued))),
          "l"(kvl + (size_t)issued * Sp * D), "r"(bytes), "r"(bar)
          : "memory");
    }
    ++issued;
  }
  // wait until unit u has landed
  __device__ void wait(int u) const {
    const unsigned G = seq0 + u;
    const uint32_t bar = smem_addr(bars + G % nb), parity = (G / nb) & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    }
  }
};

// Y[M, N] = A[M, K] . Wt[N, K]^T + bias[N] for M <= 16 rows and K = 32 KC,
// handed to epi(m, n, y): A bf16 in shared memory (row stride lda, 16-byte
// aligned rows), Wt (out, in) in global memory (L2-resident: every block
// reads the same weights), bias in shared memory. Warps take n8 tiles, up
// to R at a time (8 16-byte loads a lane: more spill the 128 registers of
// a 512-thread block), and issue every 16-byte B load of those tiles before
// their products, so that a round costs one trip to L2; lane c reads
// columns 8c .. 8c + 7 of each 32 (mma_dense_rows' order of the sums).
template <int KC, class Epi>
__device__ void rows_product(const bf16* A, int lda, int M, const bf16* __restrict__ Wt, int N,
                             const bf16* bias, Epi epi) {
  constexpr int R = KC >= 8 ? 1 : 8 / KC;  // at most 8 16-byte loads a lane in flight
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3, tiles = (N + 7) / 8;
  const bf16* a0 = A + (size_t)min(g, M - 1) * lda + 8 * c;
  const bf16* a1 = A + (size_t)min(g + 8, M - 1) * lda + 8 * c;
  for (int t0 = warp; t0 < tiles; t0 += nwarps * R) {
    uint4 bv[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t0 + r * nwarps >= tiles) break;
      const bf16* wr = Wt + (size_t)min(8 * (t0 + r * nwarps) + g, N - 1) * (32 * KC) + 8 * c;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) bv[r][kc] = *reinterpret_cast<const uint4*>(wr + 32 * kc);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tile = t0 + r * nwarps;
      if (tile >= tiles) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint4 x0 = *reinterpret_cast<const uint4*>(a0 + 32 * kc);
        const uint4 x1 = *reinterpret_cast<const uint4*>(a1 + 32 * kc);
        const uint32_t fa0[4] = {x0.x, x1.x, x0.y, x1.y}, fa1[4] = {x0.z, x1.z, x0.w, x1.w};
        const uint32_t fb0[2] = {bv[r][kc].x, bv[r][kc].y}, fb1[2] = {bv[r][kc].z, bv[r][kc].w};
        mma_bf16(acc, fa0, fb0);
        mma_bf16(acc, fa1, fb1);
      }
      const int n = 8 * tile + 2 * c;
      if (n >= N) continue;
      const float b0 = tof(bias[n]), b1 = tof(bias[n + 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = g + 8 * hh;
        if (m < M) {
          epi(m, n, acc[2 * hh] + b0);
          epi(m, n + 1, acc[2 * hh + 1] + b1);
        }
      }
    }
  }
}

// Self-attention of the P <= 16 rows held as q | k | v in shared memory
// (row stride ld), one warp per head: the 16 keys' scores in registers, the
// exact softmax by quad shuffles, bf16(P) v (the plain version's rounding
// points; mma.cuh's attention tiles at a 16-key block).
template <int D>
__device__ void chunk_self_attention(const bf16* qkv, int ld, int P, int E, int H, bf16* out,
                                     int ldo) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int h = warp; h < H; h += nwarps) {
    uint32_t qa[D / 16][4];
    load_q<D, true>(qa, qkv + h * D, ld, 0, P);
    float s[2][4];
    scores<D, 2, true, true>(s, qa, qkv + E + h * D, ld, 0, P);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m = quad_max(fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                                     fmaxf(s[1][2 * hh], s[1][2 * hh + 1])));
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * hh] = __expf(s[j][2 * hh] - m);
        s[j][2 * hh + 1] = __expf(s[j][2 * hh + 1] - m);
        l += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l = 1.f / quad_sum(l);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * hh] *= l;
        s[j][2 * hh + 1] *= l;
      }
    }
    float o[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    pv_step<D, true>(o, s[0], s[1], qkv + 2 * E + h * D, ld, 0, P);
    store_rows<D>(o, 0, P, out + h * D, ldo);
  }
}

// The small per-layer tensors, copied into shared memory once per chunk, in
// this order: ln_s, ln_b (L, 3, E), the biases qkv_b (L, 3E), so_b, cq_b,
// co_b, m1_b, m2_b (L, E), emb_b (E), pe (P, E), fc_b (J). The kernel
// addresses them from the block's base (chunk_param) rather than holding
// eleven pointers in registers.
enum ChunkParam { kLnS, kLnB, kQkvB, kSoB, kCqB, kCoB, kM1B, kM2B, kEmbB, kPe, kFcB };

__host__ __device__ inline int chunk_param_offset(int k, int L, int E, int P) {
  const int LE = L * E;
  if (k <= kQkvB) return 3 * LE * k;
  if (k <= kM2B) return 9 * LE + (k - kSoB) * LE;
  return 14 * LE + (k == kEmbB ? 0 : k == kPe ? E : E + P * E);
}

__host__ __device__ inline int chunk_param_elems(int L, int E, int P, int J) {
  return (chunk_param_offset(kFcB, L, E, P) + J + 7) / 8 * 8;
}

__device__ inline void stage_params(const ChunkArgs& a, bf16* dst) {
  const int L = a.L, E = a.E;
  const bf16* src[11] = {a.ln_s, a.ln_b, a.qkv_b, a.so_b, a.cq_b, a.co_b,
                         a.m1_b, a.m2_b, a.emb_b, a.pe, a.fc_b};
  const int n[11] = {3 * L * E, 3 * L * E, 3 * L * E, L * E, L * E, L * E, L * E, L * E,
                     E, a.P * E, a.J};
  for (int k = 0; k < 11; ++k) {
    for (int i = threadIdx.x; i < n[k]; i += blockDim.x) dst[i] = src[k][i];
    dst += n[k];
  }
}

__host__ __device__ inline size_t chunk_smem_bytes(int L, int P, int E, int H, int J, int Jp,
                                                   int Sp, int threads, int cs) {
  const int D = E / H;
  const size_t floats = r4((size_t)P * E) + 2 * r4((size_t)P * J) + (size_t)(Sp / 32) * 64 +
                        (size_t)(threads / 32) * P * D;
  const size_t halves = (size_t)chunk_param_elems(L, E, P, J) + (size_t)P * (E + 8) +
                        (size_t)P * (3 * E + 8) + (size_t)P * (Jp + 8) +
                        (size_t)kv_buffers(D, threads) * Sp * D +
                        (cs > 1 ? (size_t)2 * P * (E + 8) : 0);
  return 32 + 4 * floats + 2 * halves;  // 32: the ring's mbarriers
}

// Cross-attention of the P rows over the S + 1 keys of one layer for the
// block's heads hbase .. hbase + Hl - 1, hp heads at a time (hp = 2 when the
// ring holds their four units and half the warps hold a head's keys, else 1):
//   out[:, h D .. h D + D) = bf16( bf16(softmax(q_h k_h^T / sqrt(D))) v_h )
// with q (P, E) bf16 in shared memory (ldq) and the heads' K / V units
// arriving through kv (whose first units the caller issued earlier); the
// result also goes to peer (the other block of a 2-block cluster) unless
// that is null. A
// head's warps split its keys in 32-key chunks: pass 1 scores a warp's
// chunks from K in shared memory, keeps the scores in registers and writes
// each chunk's row max and sum of exp to red; pass 2 merges them in chunk
// order (the quad's four lanes over every fourth chunk), normalises, rounds
// P to bf16 (the plain version's rounding point) and adds P v into the
// warp's fp32 partial; the partials are summed in warp order and rounded
// once. Unit u + NB is issued into a buffer once unit u in it is consumed,
// at the end of the phase after it (where a warp would wait at the
// barrier). red: hp (Sp / 32) 32 floats, part: nwarps P D floats of shared
// memory. Three block barriers per hp heads.
template <int D>
__device__ void chunk_cross_attention(const bf16* q, int ldq, KvStream<D>& kv, int P, int hbase,
                                      int H, int S, float* red, float* part, bf16* out, int ldo,
                                      bf16* peer) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int Sp = kv.Sp, nch = Sp / 32, nkeys = S + 1;
  const int hp = kv.nb == 4 && H % 2 == 0 && nch <= kMaxChunks * nwarps / 2 ? 2 : 1;
  const int wph = nwarps / hp, hg = warp / wph, sub = warp % wph, nparts = min(nch, wph);
  float* red_h = red + (size_t)hg * nch * 32;
  for (int h0 = 0; h0 < H; h0 += hp) {
    const int h = h0 + hg;
    uint32_t qa[D / 16][4];
    load_q<D, true>(qa, q + (hbase + h) * D, ldq, 0, P);
    // every thread waits on each K unit it or another warp reads: a wait on
    // one mbarrier orders nothing of another unit's copy
    for (int hq = 0; hq < hp; ++hq) kv.wait(2 * (h0 + hq));
    __syncthreads();  // the heads' K has landed; the last heads' partials are summed
    const uint4* kh = reinterpret_cast<const uint4*>(kv.buffer(2 * h));
    // pass 1: this warp's chunks, scores kept in registers
    float s[kMaxChunks][4][4];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = sub + i * wph;
      if (ch >= nch) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 kr[D / 32];
#pragma unroll
        for (int u = 0; u < D / 32; ++u) kr[u] = kh[((4 * ch + j) * 32 + lane) * (D / 32) + u];
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(kr);
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t b[2] = {w[2 * kd], w[2 * kd + 1]};
          mma_bf16(s[i][j], qa[kd], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 32 * ch + 8 * j + 2 * c + (e & 1);
          s[i][j][e] = key < nkeys ? s[i][j][e] * attn_scale<D>() : -INFINITY;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float bm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) bm = fmaxf(bm, fmaxf(s[i][j][2 * hh], s[i][j][2 * hh + 1]));
        const float m = quad_max(bm);  // finite: key 32 ch < nkeys is in the chunk
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) l += __expf(s[i][j][2 * hh] - m) + __expf(s[i][j][2 * hh + 1] - m);
        l = quad_sum(l);
        if (c == 0) {
          red_h[2 * (ch * 16 + g + 8 * hh)] = m;
          red_h[2 * (ch * 16 + g + 8 * hh) + 1] = l;
        }
      }
    }
    for (int hq = 0; hq < hp; ++hq) kv.wait(2 * (h0 + hq) + 1);
    __syncthreads();  // the heads' V has landed; their K is consumed; the chunk statistics are in
    // pass 2: the rows' max and sum over every chunk, in chunk order per lane
    float mx[2], inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* st = red_h + 2 * (g + 8 * hh);
      float m = -INFINITY;
      for (int ch = c; ch < nch; ch += 4) m = fmaxf(m, st[32 * ch]);
      m = quad_max(m);
      float l = 0.f;
      for (int ch = c; ch < nch; ch += 4) l += st[32 * ch + 1] * __expf(st[32 * ch] - m);
      mx[hh] = m;
      inv[hh] = 1.f / quad_sum(l);
    }
    const uint4* vh = reinterpret_cast<const uint4*>(kv.buffer(2 * h + 1));
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = sub + i * wph;
      if (ch >= nch) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = __expf(s[i][j][e] - mx[e >> 1]) * inv[e >> 1];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint4 vr[D / 16];
#pragma unroll
        for (int u = 0; u < D / 16; ++u) vr[u] = vh[((2 * ch + kk) * 32 + lane) * (D / 16) + u];
        const uint32_t* w = reinterpret_cast<const uint32_t*>(vr);
        uint32_t pa[4];
        acc_to_a(pa, s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const uint32_t b[2] = {w[2 * n], w[2 * n + 1]};
          mma_bf16(o[n], pa, b);
        }
      }
    }
    if (sub < nparts) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        if (r >= P) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          float* p = part + ((size_t)warp * P + r) * D + 8 * n + 2 * c;
          p[0] = o[n][2 * hh];
          p[1] = o[n][2 * hh + 1];
        }
      }
    }
    // the next unit, into the first K buffer of these heads (issued here,
    // where a warp would wait)
    kv.issue();
    __syncthreads();  // V is consumed; the partials are in
    for (int i = threadIdx.x; i < hp * P * D; i += blockDim.x) {
      const int hq = i / (P * D), r = (i / D) % P, d = i % D;
      float acc = 0.f;
      for (int w = 0; w < nparts; ++w) acc += part[((size_t)(hq * wph + w) * P + r) * D + d];
      const size_t o = (size_t)r * ldo + (hbase + h0 + hq) * D + d;
      const bf16 v = __float2bfloat16(acc);
      out[o] = v;
      if (peer) peer[o] = v;
    }
    // the units after it, into the buffers of the rest of these heads' units
    for (int u = 1; u < 2 * hp; ++u) kv.issue();
  }
}

// the embedding's product: K = Jp = 32 or 64
template <class Epi>
__device__ void embed_product(const bf16* xin, int ldx, int P, int Jp, const bf16* __restrict__ w,
                              int E, const bf16* bias, Epi epi) {
  if (Jp == 32) {
    rows_product<1>(xin, ldx, P, w, E, bias, epi);
  } else {
    rows_product<2>(xin, ldx, P, w, E, bias, epi);
  }
}

// The context K/V projection of heads hbase .. hbase + Hl - 1 of every layer
// for the robot's S context rows ctx: all of them (2 L E columns) in one
// product, or a layer's E / cs columns at a time.
template <int D>
__device__ void project_context_kv(const ChunkArgs& a, const bf16* ctx, int hbase, int Hl,
                                   bf16* kv) {
  const int E = a.E, S = a.S;
  if (Hl == a.H) {
    mma_dense_rows<2, 4>(ctx, E, S, E, a.kv_t, E, 2 * a.L * E, a.kv_b, KvFragEpi{kv, D, a.Sp, 0});
    return;
  }
  for (int l = 0; l < a.L; ++l) {
    const int lhs0 = (l * a.H + hbase) * 2;
    mma_dense_rows<2, 4>(ctx, E, S, E, a.kv_t + (size_t)lhs0 * D * E, E, 2 * Hl * D,
                         a.kv_b + lhs0 * D, KvFragEpi{kv, D, a.Sp, lhs0});
  }
}

// CS blocks a robot: 1, or a cluster of 2 that splits its heads (hbase ..
// hbase + Hl - 1 in this block)
template <int D, int KC, int CS>
__global__ void __launch_bounds__(kChunkThreads) fused_chunk_kernel(ChunkArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int cs = CS;
  const int rank = blockIdx.x % cs, b = blockIdx.x / cs;
  const int E = 32 * KC, L = a.L, H = a.H, Hl = H / cs, hbase = rank * Hl;
  const int P = a.P, J = a.J, Jp = a.Jp;
  const int S = a.S, Sp = a.Sp, nch = Sp / 32, PJ = P * J;
  const int lda = E + 8, ldw = 3 * E + 8, ldx = Jp + 8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);  // the ring's mbarriers (4 slots)
  float* h = reinterpret_cast<float*>(bars + 4);          // (P, E) fp32 residual
  float* x = h + r4((size_t)P * E);             // (P, J) solver carry
  float* x0c = x + r4((size_t)PJ);
  float* red = x0c + r4((size_t)PJ);            // (2, nch, 16, 2) chunk statistics of 1-2 heads
  float* part = red + (size_t)nch * 64;         // (warps, P, D) attention partials
  bf16* params = reinterpret_cast<bf16*>(part + (size_t)(blockDim.x / 32) * P * D);
  bf16* act = params + chunk_param_elems(L, E, P, J);  // (P, E + 8)
  bf16* wide = act + (size_t)P * lda;                   // (P, 3E + 8)
  bf16* xin = wide + (size_t)P * ldw;                   // (P, Jp + 8) bf16 embedding input
  bf16* ring = xin + (size_t)P * ldx;                   // a.nbuf K / V units of Sp D
  bf16* xo = ring + (size_t)a.nbuf * Sp * D;  // cs > 1: 2 (P, E + 8) cross-attention outputs
  const size_t kv_layer = (size_t)H * 2 * Sp * D;
  bf16* kv = a.kv + (size_t)b * L * kv_layer;
  if (threadIdx.x < a.nbuf)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + threadIdx.x))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  stage_params(a, params);
  // layer l's staged tensor k (per-layer width w)
  auto prm = [&](ChunkParam k, int l, int w) { return params + chunk_param_offset(k, L, E, P) + l * w; };

  // once per chunk: this robot's context K/V for every layer and the
  // block's heads, in fragment order; keys past S are zero (key S: the step
  // token, per step)
  project_context_kv<D>(a, a.context + (size_t)b * S * E, hbase, Hl, kv);
  const int pad = Sp - S - 1;
  for (int i = threadIdx.x; i < L * Hl * 2 * pad * D; i += blockDim.x) {
    const int d = i % D, s = S + 1 + (i / D) % pad, u = i / (D * pad);
    const int lhs = ((u / (2 * Hl)) * H + hbase) * 2 + u % (2 * Hl);
    kv[(size_t)lhs * Sp * D + ((lhs & 1) ? vfrag(s, d, D) : kfrag(s, d, D))] = __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < P * Jp; i += blockDim.x) {
    const int m = i / Jp, j = i % Jp;
    const float v = j < J ? a.noise[(size_t)b * PJ + m * J + j] : 0.f;
    if (j < J) {
      x[m * J + j] = v;
      x0c[m * J + j] = 0.f;
    }
    xin[m * ldx + j] = __float2bfloat16(v);
  }
  robot_sync(cs);  // a cluster's blocks both run before either writes the other's shared memory
  unsigned kv_seq = 0;  // K / V units this block has streamed
  for (int t = 0; t < a.T; ++t) {
    // the step token: key S of every layer's K and V
    const bf16* stk = a.stk + (size_t)t * L * E;
    const bf16* stv = a.stv + (size_t)t * L * E;
    for (int i = threadIdx.x; i < L * Hl * D; i += blockDim.x) {
      const int l = i / (Hl * D), e = hbase * D + i % (Hl * D), hh = e / D, d = e % D;
      bf16* blk = kv + (size_t)(l * H + hh) * 2 * Sp * D;
      blk[kfrag(S, d, D)] = stk[l * E + e];
      blk[(size_t)Sp * D + vfrag(S, d, D)] = stv[l * E + e];
    }
    // the scratch's writes (the projection's, the step token's) before the
    // bulk copies read it: the copies are the async proxy's
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    // embedding + positional encoding into the fp32 residual stream
    embed_product(xin, ldx, P, Jp, a.emb_t, E, prm(kEmbB, 0, 0), EmbedEpi{h, prm(kPe, 0, 0), E});
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const size_t EE = (size_t)E * E;
      const bf16* ln_s = prm(kLnS, l, 3 * E);
      const bf16* ln_b = prm(kLnB, l, 3 * E);
      const bf16* kvl = kv + l * kv_layer + (size_t)hbase * 2 * Sp * D;
      // this layer's first K / V units start towards shared memory while
      // the block works on the self-attention
      KvStream<D> kvs{kvl, ring, bars, Sp, a.nbuf, 2 * Hl, 0, kv_seq};
      kv_seq += 2 * Hl;
      for (int u = 0; u < a.nbuf; ++u) kvs.issue();
      // self-attention
      ln_bf16_rows(h, P, E, ln_s, ln_b, act, lda);
      __syncthreads();
      rows_product<KC>(act, lda, P, a.qkv_t + l * 3 * EE, 3 * E, prm(kQkvB, l, 3 * E),
                       StoreRoundBf16{wide, ldw});
      __syncthreads();
      chunk_self_attention<D>(wide, ldw, P, E, H, act, lda);
      __syncthreads();
      rows_product<KC>(act, lda, P, a.so_t + l * EE, E, prm(kSoB, l, E), AddTo{h, E});
      __syncthreads();
      // cross-attention over the context K/V + the step token
      ln_bf16_rows(h, P, E, ln_s + E, ln_b + E, act, lda);
      __syncthreads();
      rows_product<KC>(act, lda, P, a.cq_t + l * EE, E, prm(kCqB, l, E),
                       StoreRoundBf16{wide, ldw});
      __syncthreads();
      // a 2-block cluster: each block's heads into both blocks' xo, the two
      // buffers in turn (the other block may still read the last pass's)
      bf16* xa = cs > 1 ? xo + (size_t)((t * L + l) & 1) * P * lda : act;
      chunk_cross_attention<D>(wide, ldw, kvs, P, hbase, Hl, S, red, part, xa, lda,
                               cs > 1 ? cluster_peer(xa, rank ^ 1) : nullptr);
      robot_sync(cs);
      rows_product<KC>(xa, lda, P, a.co_t + l * EE, E, prm(kCoB, l, E), AddTo{h, E});
      __syncthreads();
      // MLP
      ln_bf16_rows(h, P, E, ln_s + 2 * E, ln_b + 2 * E, act, lda);
      __syncthreads();
      rows_product<KC>(act, lda, P, a.m1_t + l * EE, E, prm(kM1B, l, E),
                       GeluBf16<false>{wide, ldw});
      __syncthreads();
      rows_product<KC>(wide, ldw, P, a.m2_t + l * EE, E, prm(kM2B, l, E), AddTo{h, E});
      __syncthreads();
    }
    // output projection of the bf16-rounded residual stream; the solver
    // update in its epilogue
    for (int i = threadIdx.x; i < P * E; i += blockDim.x)
      act[(i / E) * lda + i % E] = __float2bfloat16(h[i]);
    __syncthreads();
    const float* cf = a.coef + 5 * t;
    rows_product<KC>(act, lda, P, a.fc_t, J, prm(kFcB, 0, 0),
                     SolverEpi{x, x0c, xin, J, ldx, cf[0], cf[1], cf[2], cf[3], cf[4]});
    __syncthreads();
  }
  if (rank == 0)
    for (int i = threadIdx.x; i < PJ; i += blockDim.x) a.out[(size_t)b * PJ + i] = x[i];
}

}  // namespace sd

// ptrs: the 21 ChunkArgs weight pointers (declaration order: emb_t ..
//       kv_b), noise, context, stk, stv, coef, kv scratch, out
// ints: L, E, H, P, J, Jp, B, S, Sp, T, threads per block (512, or 256:
//       two blocks on an SM at head_dim 32), blocks a robot (1, or 2: a
//       cluster of two splitting the heads)
extern "C" int sd_fused_chunk(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  ChunkArgs a;
  const bf16** w = &a.emb_t;  // the 21 weights in declaration order
  for (int i = 0; i < 21; ++i) w[i] = static_cast<const bf16*>(ptrs[i]);
  a.noise = static_cast<const float*>(ptrs[21]);
  a.context = static_cast<const bf16*>(ptrs[22]);
  a.stk = static_cast<const bf16*>(ptrs[23]);
  a.stv = static_cast<const bf16*>(ptrs[24]);
  a.coef = static_cast<const float*>(ptrs[25]);
  a.kv = static_cast<bf16*>(const_cast<void*>(ptrs[26]));
  a.out = static_cast<float*>(const_cast<void*>(ptrs[27]));
  a.L = ints[0];
  a.E = ints[1];
  a.H = ints[2];
  a.P = ints[3];
  a.J = ints[4];
  a.Jp = ints[5];
  a.B = ints[6];
  a.S = ints[7];
  a.Sp = ints[8];
  a.T = ints[9];
  const int threads = ints[10], cs = ints[11], D = head_dim(a.E, a.H);
  if (D == 0 || a.P < 1 || a.P > 16 || (a.Jp != 32 && a.Jp != 64) || a.Jp < a.J || a.J % 2 != 0 ||
      a.Sp != (a.S + 1 + 31) / 32 * 32 || (threads != kChunkThreads && threads != 256) ||
      a.Sp > 32 * kMaxChunks * (threads / 32) || (a.E != 128 && a.E != 256) ||
      (cs != 1 && cs != 2) || a.H % cs != 0)
    return (int)cudaErrorInvalidValue;
  a.nbuf = kv_buffers(D, threads);
  void (*kernel)(ChunkArgs);
  if (D == 32) {
    kernel = cs == 1 ? fused_chunk_kernel<32, 4, 1> : fused_chunk_kernel<32, 4, 2>;
  } else if (a.E == 128) {
    kernel = cs == 1 ? fused_chunk_kernel<64, 4, 1> : fused_chunk_kernel<64, 4, 2>;
  } else {
    kernel = cs == 1 ? fused_chunk_kernel<64, 8, 1> : fused_chunk_kernel<64, 8, 2>;
  }
  if (D == 32 && a.E != 128) return (int)cudaErrorInvalidValue;
  const size_t smem = chunk_smem_bytes(a.L, a.P, a.E, a.H, a.J, a.Jp, a.Sp, threads, cs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
