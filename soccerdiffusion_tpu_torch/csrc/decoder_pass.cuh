// One pass of the cross-attending decoder for one robot on the tensor cores:
// the device code that the whole-chunk sampler (fused_chunk.cu, once per
// solver step) and the serving denoiser (fused_denoise.cu, once per launch)
// share. A pass is the embedding of the bf16 noisy chunk and the positional
// table, L x [pre-norm self-attention, pre-norm cross-attention over the S
// context keys and the step token in one softmax, exact-GELU MLP] and the
// output product, whose epilogue the kernel supplies (the solver update, or
// eps / the DDIM step).
//
// The context K/V of a robot lie in global memory as (L, H, 2, Sp D): per
// (layer, head) its K (Sp keys x D in score-fragment order, kfrag) and its V
// (value-fragment order, vfrag), key S the step token (written by the
// kernel before each pass, write_step_token), keys past S zero. The
// cross-attention streams each such unit into a ring of shared-memory
// buffers with one bulk copy (TMA) on an mbarrier (KvStream). Everything
// else of the pass (the fp32 residual, the bf16 activations, the LayerNorm
// parameters and biases) stays in shared memory (carve_pass_smem); the
// serving weights, transposed (out, in), are read from L2 by every block.
// A robot runs on one block of 16 warps (kPassThreads), two 8-warp blocks
// an SM, or a cluster of two blocks that split its heads (CS = 2).
#pragma once

#include "encoder_layer.cuh"

namespace sd {

// What a pass reads: the serving weights, bf16, Dense kernels transposed
// (out, in), per-layer tensors stacked on a leading L axis
// (ops/fused_denoise.py:pack_kernel_weights), and the shapes.
struct PassArgs {
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
  int L, E, H, P, J, Jp, B, S, Sp;
  int nbuf;           // K / V units in the cross-attention's ring (2 .. 4)
};
constexpr int kPassWeights = 19;  // the pointers of PassArgs, emb_t .. fc_b

constexpr int kPassThreads = 512;

// most 32-key chunks a warp scores per head (its scores stay in registers):
// S + 1 <= 32 kMaxChunks x 16 warps keys
constexpr int kMaxChunks = 2;

// K / V units (one head's Sp x D keys of K or of V) in the cross-attention's
// ring of shared-memory buffers: 4 at head_dim 32 with 16 warps (20 KB
// each at S=301), else 2 (two 41 KB units at head_dim 64; two blocks of 8
// warps on an SM at head_dim 32)
__host__ __device__ inline int kv_buffers(int D, int threads) {
  return D == 32 && threads == kPassThreads ? 4 : 2;
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

// The small per-layer tensors, copied into shared memory once per launch, in
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

__device__ inline void stage_params(const PassArgs& a, bf16* dst) {
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

// Shared memory of a pass (carve_pass_smem), for a kernel that keeps
// `carry` fp32 floats of its own (a multiple of 4) beside the residual.
__host__ __device__ inline size_t pass_smem_bytes(int L, int P, int E, int H, int J, int Jp,
                                                  int Sp, int threads, int cs, size_t carry) {
  const int D = E / H;
  const size_t floats = r4((size_t)P * E) + carry + (size_t)(Sp / 32) * 64 +
                        (size_t)(threads / 32) * P * D;
  const size_t halves = (size_t)chunk_param_elems(L, E, P, J) + (size_t)P * (E + 8) +
                        (size_t)P * (3 * E + 8) + (size_t)P * (Jp + 8) +
                        (size_t)kv_buffers(D, threads) * Sp * D +
                        (cs > 1 ? (size_t)2 * P * (E + 8) : 0);
  return 32 + 4 * floats + 2 * halves;  // 32: the ring's mbarriers
}

struct PassSmem {
  uint64_t* bars;  // the ring's mbarriers (4 slots)
  float* h;        // (P, E) fp32 residual
  float* carry;    // the kernel's own floats
  float* red;      // (2, nch, 16, 2) chunk statistics of 1-2 heads
  float* part;     // (warps, P, D) attention partials
  bf16* params;    // the staged parameters (stage_params)
  bf16* act;       // (P, E + 8)
  bf16* wide;      // (P, 3E + 8)
  bf16* xin;       // (P, Jp + 8) bf16 embedding input
  bf16* ring;      // nbuf K / V units of Sp D
  bf16* xo;        // cs > 1: 2 (P, E + 8) cross-attention outputs
};

template <int D>
__device__ inline PassSmem carve_pass_smem(float4* base, const PassArgs& a, size_t carry) {
  PassSmem s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.h = reinterpret_cast<float*>(s.bars + 4);
  s.carry = s.h + r4((size_t)a.P * a.E);
  s.red = s.carry + carry;
  s.part = s.red + (size_t)(a.Sp / 32) * 64;
  s.params = reinterpret_cast<bf16*>(s.part + (size_t)(blockDim.x / 32) * a.P * D);
  s.act = s.params + chunk_param_elems(a.L, a.E, a.P, a.J);
  s.wide = s.act + (size_t)a.P * (a.E + 8);
  s.xin = s.wide + (size_t)a.P * (3 * a.E + 8);
  s.ring = s.xin + (size_t)a.P * (a.Jp + 8);
  s.xo = s.ring + (size_t)a.nbuf * a.Sp * D;
  return s;
}

// the ring's mbarriers, one arrival each
__device__ inline void init_kv_ring(uint64_t* bars, int nbuf) {
  if (threadIdx.x < nbuf)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + threadIdx.x))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The step token: key S of every layer's K and V of the block's heads hbase
// .. hbase + Hl - 1 in the robot's (L, H, 2, Sp D) K/V, from the per-layer
// rows stk / stv (L, E); then the fence that orders these writes (and any
// earlier ones of the block) before the bulk copies, the async proxy's,
// read them.
template <int D>
__device__ inline void write_step_token(bf16* kv, const bf16* stk, const bf16* stv, int L, int H,
                                        int hbase, int Hl, int S, int Sp) {
  const int E = H * D;
  for (int i = threadIdx.x; i < L * Hl * D; i += blockDim.x) {
    const int l = i / (Hl * D), e = hbase * D + i % (Hl * D), hh = e / D, d = e % D;
    bf16* blk = kv + (size_t)(l * H + hh) * 2 * Sp * D;
    blk[kfrag(S, d, D)] = stk[l * E + e];
    blk[(size_t)Sp * D + vfrag(S, d, D)] = stv[l * E + e];
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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

// One decoder pass of the robot whose (L, H, 2, Sp D) K/V are kv, on its P
// rows: the embedding of the bf16 input in sm.xin (the caller writes it),
// the L layers, the output product of the bf16-rounded residual handed to
// epi(m, n, eps). The block's heads are hbase .. hbase + Hl - 1 (Hl = H /
// CS, hbase = rank Hl); kv_seq counts the K / V units the block has
// streamed (over every pass of the launch); `pass` picks, in a 2-block
// cluster, which of the two cross-attention output buffers each layer
// writes (the other block may still read the last layer's).
template <int D, int KC, int CS, class Epi>
__device__ __forceinline__ void decoder_pass(const PassArgs& a, const PassSmem& sm, const bf16* kv,
                                             int rank, unsigned& kv_seq, int pass, Epi epi) {
  constexpr int cs = CS;
  const int E = 32 * KC, L = a.L, H = a.H, Hl = H / cs, hbase = rank * Hl;
  const int P = a.P, Jp = a.Jp, S = a.S, Sp = a.Sp;
  const int lda = E + 8, ldw = 3 * E + 8, ldx = Jp + 8;
  const size_t kv_layer = (size_t)H * 2 * Sp * D;
  float* h = sm.h;
  bf16 *act = sm.act, *wide = sm.wide;
  // layer l's staged tensor k (per-layer width w)
  auto prm = [&](ChunkParam k, int l, int w) { return sm.params + chunk_param_offset(k, L, E, P) + l * w; };
  // embedding + positional encoding into the fp32 residual stream
  embed_product(sm.xin, ldx, P, Jp, a.emb_t, E, prm(kEmbB, 0, 0), EmbedEpi{h, prm(kPe, 0, 0), E});
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const size_t EE = (size_t)E * E;
    const bf16* ln_s = prm(kLnS, l, 3 * E);
    const bf16* ln_b = prm(kLnB, l, 3 * E);
    const bf16* kvl = kv + l * kv_layer + (size_t)hbase * 2 * Sp * D;
    // this layer's first K / V units start towards shared memory while
    // the block works on the self-attention
    KvStream<D> kvs{kvl, sm.ring, sm.bars, Sp, a.nbuf, 2 * Hl, 0, kv_seq};
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
    rows_product<KC>(act, lda, P, a.cq_t + l * EE, E, prm(kCqB, l, E), StoreRoundBf16{wide, ldw});
    __syncthreads();
    // a 2-block cluster: each block's heads into both blocks' xo, the two
    // buffers in turn (the other block may still read the last layer's)
    bf16* xa = cs > 1 ? sm.xo + (size_t)((pass * L + l) & 1) * P * lda : act;
    chunk_cross_attention<D>(wide, ldw, kvs, P, hbase, Hl, S, sm.red, sm.part, xa, lda,
                             cs > 1 ? cluster_peer(xa, rank ^ 1) : nullptr);
    robot_sync(cs);
    rows_product<KC>(xa, lda, P, a.co_t + l * EE, E, prm(kCoB, l, E), AddTo{h, E});
    __syncthreads();
    // MLP
    ln_bf16_rows(h, P, E, ln_s + 2 * E, ln_b + 2 * E, act, lda);
    __syncthreads();
    rows_product<KC>(act, lda, P, a.m1_t + l * EE, E, prm(kM1B, l, E), GeluBf16<false>{wide, ldw});
    __syncthreads();
    rows_product<KC>(wide, ldw, P, a.m2_t + l * EE, E, prm(kM2B, l, E), AddTo{h, E});
    __syncthreads();
  }
  // output projection of the bf16-rounded residual stream
  for (int i = threadIdx.x; i < P * E; i += blockDim.x)
    act[(i / E) * lda + i % E] = __float2bfloat16(h[i]);
  __syncthreads();
  rows_product<KC>(act, lda, P, a.fc_t, a.J, prm(kFcB, 0, 0), epi);
  __syncthreads();
}

// The shapes both kernels take (the wrappers' check_kernel_shapes raises
// before a launch gets here): threads 512, or 256 at head_dim 32; blocks a
// robot 1 or 2.
__host__ inline bool pass_shape_ok(const PassArgs& a, int D, int threads, int cs) {
  return D != 0 && a.P >= 1 && a.P <= 16 && (a.Jp == 32 || a.Jp == 64) && a.Jp >= a.J &&
         a.J % 2 == 0 && a.Sp == (a.S + 1 + 31) / 32 * 32 &&
         (threads == kPassThreads || threads == 256) &&
         a.Sp <= 32 * kMaxChunks * (threads / 32) && (a.E == 128 || a.E == 256) &&
         (D == 64 || a.E == 128) && (cs == 1 || cs == 2) && a.H % cs == 0;
}

// Launch `kernel` with a block (CS = 1) or a 2-block cluster (CS = 2) a robot.
template <class Args>
__host__ inline int launch_robots(void (*kernel)(Args), const Args& a, int threads, int cs,
                                  size_t smem, void* stream) {
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

}  // namespace sd
