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
//
// Head_dim 128 (hidden 512: the larger_model configuration, kWideHead) has a
// plan of its own, since the one above needs ~438 KB there (one (layer,
// head) K or V unit is 80 KB at Sp = 320; the 8 layers' LayerNorm
// parameters and biases 126 KB; the attention partials of 16 warps 80 KB),
// against the 227 KB a block has:
//   * 8 warps a robot (kWideThreads), so that a thread has up to 255
//     registers: an attention warp's q fragments and D = 128 output
//     accumulators take 96, rows_product<16>'s weight loads 64;
//   * no staged parameters: the LayerNorms and the products' epilogues read
//     the layer's parameters and biases from global memory (L2), where they
//     are used;
//   * the cross-attention streams K and V in 32-key chunks (8 KB each, one
//     bulk copy) into a ring of kChunkRing buffers: a head's whole K is in
//     flight before its scores, and its first V chunks behind it
//     (KvStream<D, true>, chunk_cross_attention on it).
// Shared memory at P = 10, S = 311 (pass_smem_bytes): 201 KiB a robot, 222
// KiB a block of a 2-block cluster (the chunk sampler; the denoiser 2 KiB less).
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
  int nbuf;           // K / V units in the cross-attention's ring (2 .. 4, or kChunkRing)
};
constexpr int kPassWeights = 19;  // the pointers of PassArgs, emb_t .. fc_b

constexpr int kPassThreads = 512;

// most 32-key chunks a warp scores per head (its scores stay in registers):
// S + 1 <= 32 kMaxChunks x 16 warps keys
constexpr int kMaxChunks = 2;

// head_dim 128: its plan (above), its block, its ring of 32-key chunks
constexpr int kWideHead = 128;
constexpr int kWideThreads = 256;
constexpr int kChunkRing = 12;  // a head's whole K: Sp <= 384, S <= 383

// whether the pass stages the per-layer parameters in shared memory
__host__ __device__ constexpr bool staged_params(int D) { return D != kWideHead; }

// K / V units (one head's Sp x D keys of K or of V) in the cross-attention's
// ring of shared-memory buffers: 4 at head_dim 32 with 16 warps (20 KB
// each at S=301), else 2 (two 41 KB units at head_dim 64; two blocks of 8
// warps on an SM at head_dim 32); at head_dim 128 kChunkRing 32-key chunks
__host__ __device__ inline int kv_buffers(int D, int threads) {
  return D == kWideHead ? kChunkRing : D == 32 && threads == kPassThreads ? 4 : 2;
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
// kChunks (head_dim 128): a unit is a 32-key chunk instead, unit u of the
// layer chunk u % (Sp / 32) of K or V unit u / (Sp / 32) (a chunk of the
// fragment orders is 32 D contiguous elements). T: the scratch's element
// (bf16, or int8 in fused_chunk_int8.cu).
template <int D, bool kChunks = false, class T = bf16>
struct KvStream {
  const T* kvl;  // the layer's (H, 2, Sp D) scratch
  T* ring;       // nb buffers of elems()
  uint64_t* bars;   // nb mbarriers
  int Sp, nb, units, issued;
  unsigned seq0;

  __device__ int elems() const { return kChunks ? 32 * D : Sp * D; }
  __device__ const T* buffer(int u) const { return ring + (size_t)((seq0 + u) % nb) * elems(); }
  // issue the next unit, if any
  __device__ void issue() {
    if (issued < units && threadIdx.x == 0) {
      const unsigned G = seq0 + issued;
      const uint32_t bar = smem_addr(bars + G % nb), bytes = (uint32_t)(elems() * sizeof(T));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(buffer(issued))),
          "l"(kvl + (size_t)issued * elems()), "r"(bytes), "r"(bar)
          : "memory");
    }
    ++issued;
  }
  // issue every unit before n that is not issued yet
  __device__ void issue_upto(int n) {
    while (issued < min(n, units)) issue();
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

// tensor k of the list above in global memory (head_dim 128 reads them there)
__device__ __forceinline__ const bf16* param_src(const PassArgs& a, ChunkParam k) {
  switch (k) {
    case kLnS: return a.ln_s;
    case kLnB: return a.ln_b;
    case kQkvB: return a.qkv_b;
    case kSoB: return a.so_b;
    case kCqB: return a.cq_b;
    case kCoB: return a.co_b;
    case kM1B: return a.m1_b;
    case kM2B: return a.m2_b;
    case kEmbB: return a.emb_b;
    case kPe: return a.pe;
    default: return a.fc_b;
  }
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

// mbarrier slots at the base of a pass's shared memory: the ring's, rounded
// up to 16 bytes
__host__ __device__ constexpr int bar_slots(int D) { return D == kWideHead ? 16 : 4; }

// Shared memory of a pass (carve_pass_smem), for a kernel that keeps
// `carry` fp32 floats of its own (a multiple of 4) beside the residual.
__host__ __device__ inline size_t pass_smem_bytes(int L, int P, int E, int H, int J, int Jp,
                                                  int Sp, int threads, int cs, size_t carry) {
  const int D = E / H;
  const size_t floats = r4((size_t)P * E) + carry + (size_t)(Sp / 32) * 64 +
                        (size_t)(threads / 32) * P * D;
  const size_t halves = (staged_params(D) ? (size_t)chunk_param_elems(L, E, P, J) : 0) +
                        (size_t)P * (E + 8) + (size_t)P * (3 * E + 8) + (size_t)P * (Jp + 8) +
                        (size_t)kv_buffers(D, threads) * (D == kWideHead ? 32 : Sp) * D +
                        (cs > 1 ? (size_t)2 * P * (E + 8) : 0);
  return 8 * (size_t)bar_slots(D) + 4 * floats + 2 * halves;
}

struct PassSmem {
  uint64_t* bars;  // the ring's mbarriers (bar_slots)
  float* h;        // (P, E) fp32 residual
  float* carry;    // the kernel's own floats
  float* red;      // (2, nch, 16, 2) chunk statistics of 1-2 heads
  float* part;     // (warps, P, D) attention partials
  bf16* params;    // the staged parameters (stage_params; none at head_dim 128)
  bf16* act;       // (P, E + 8)
  bf16* wide;      // (P, 3E + 8)
  bf16* xin;       // (P, Jp + 8) bf16 embedding input
  bf16* ring;      // nbuf K / V units of Sp D (head_dim 128: 32-key chunks, 32 D)
  bf16* xo;        // cs > 1: 2 (P, E + 8) cross-attention outputs
};

template <int D>
__device__ inline PassSmem carve_pass_smem(float4* base, const PassArgs& a, size_t carry) {
  PassSmem s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.h = reinterpret_cast<float*>(s.bars + bar_slots(D));
  s.carry = s.h + r4((size_t)a.P * a.E);
  s.red = s.carry + carry;
  s.part = s.red + (size_t)(a.Sp / 32) * 64;
  s.params = reinterpret_cast<bf16*>(s.part + (size_t)(blockDim.x / 32) * a.P * D);
  s.act = s.params + (staged_params(D) ? chunk_param_elems(a.L, a.E, a.P, a.J) : 0);
  s.wide = s.act + (size_t)a.P * (a.E + 8);
  s.xin = s.wide + (size_t)a.P * (3 * a.E + 8);
  s.ring = s.xin + (size_t)a.P * (a.Jp + 8);
  s.xo = s.ring + (size_t)a.nbuf * (D == kWideHead ? 32 : a.Sp) * D;
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

// The pieces of the cross-attention over 32-key chunks (both forms below).
// A warp's scores of chunk ch (keys 32 ch .. 32 ch + 31) of one head against
// its q fragments, from kc, the chunk's 32 D elements of K in score-fragment
// order: scaled, -inf at keys past nkeys.
template <int D>
__device__ __forceinline__ void score_chunk(float (*s)[4], uint32_t (*qa)[4], const uint4* kc,
                                            int ch, int nkeys) {
  const int lane = threadIdx.x & 31, c = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint4 kr[D / 32];
#pragma unroll
    for (int u = 0; u < D / 32; ++u) kr[u] = kc[(j * 32 + lane) * (D / 32) + u];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(kr);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t b[2] = {w[2 * kd], w[2 * kd + 1]};
      mma_bf16(s[j], qa[kd], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 32 * ch + 8 * j + 2 * c + (e & 1);
      s[j][e] = key < nkeys ? s[j][e] * attn_scale<D>() : -INFINITY;
    }
  }
}

// the chunk's row max and sum of exp of the warp's rows g, g + 8, written to
// red (32 floats a chunk) by the quad's lane 0
__device__ __forceinline__ void chunk_stats(const float (*s)[4], float* red, int ch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float bm = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) bm = fmaxf(bm, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    const float m = quad_max(bm);  // finite: key 32 ch < nkeys is in the chunk
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) l += __expf(s[j][2 * hh] - m) + __expf(s[j][2 * hh + 1] - m);
    l = quad_sum(l);
    if (c == 0) {
      red[2 * (ch * 16 + g + 8 * hh)] = m;
      red[2 * (ch * 16 + g + 8 * hh) + 1] = l;
    }
  }
}

// the rows' max and sum of exp over every chunk's statistics, in chunk order
// per lane (the quad's four lanes over every fourth chunk)
__device__ __forceinline__ void merge_stats(const float* red, int nch, float* mx, float* den) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float* st = red + 2 * (g + 8 * hh);
    float m = -INFINITY;
    for (int ch = c; ch < nch; ch += 4) m = fmaxf(m, st[32 * ch]);
    m = quad_max(m);
    float l = 0.f;
    for (int ch = c; ch < nch; ch += 4) l += st[32 * ch + 1] * __expf(st[32 * ch] - m);
    mx[hh] = m;
    den[hh] = quad_sum(l);
  }
}

// o += bf16(P) v over one chunk: its scores s turned into exp(s - mx) x sc
// in place (sc: 1 / the rows' sum, or 1 for the unnormalised P of "qstat"),
// rounded to bf16 (the plain version's rounding point), times vc, the
// chunk's 32 D elements of V in value-fragment order
template <int D>
__device__ __forceinline__ void pv_chunk(float (*o)[4], float (*s)[4], const uint4* vc,
                                         const float* mx, const float* inv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - mx[e >> 1]) * inv[e >> 1];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint4 vr[D / 16];
#pragma unroll
    for (int u = 0; u < D / 16; ++u) vr[u] = vc[(kk * 32 + lane) * (D / 16) + u];
    const uint32_t* w = reinterpret_cast<const uint32_t*>(vr);
    uint32_t pa[4];
    acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t b[2] = {w[2 * n], w[2 * n + 1]};
      mma_bf16(o[n], pa, b);
    }
  }
}

// the probability scales of pv_chunk from the rows' sums: 1 / den, or 1
// where the value sum is divided by den afterwards ("qstat": div_rows)
__device__ __forceinline__ void prob_scale(const float* den, float* sc, bool qstat) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) sc[hh] = qstat ? 1.f : 1.f / den[hh];
}

// "qstat": the warp's fp32 value sums of the unnormalised P over the rows' sums
template <int D>
__device__ __forceinline__ void div_rows(float (*o)[4], const float* den) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] / den[e >> 1];
}

// the warp's fp32 partial (rows g, g + 8 < P of its D / 8 accumulator tiles)
// into part (P, D)
template <int D>
__device__ __forceinline__ void store_partial(const float (*o)[4], int P, float* part) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = g + 8 * hh;
    if (r >= P) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float* p = part + (size_t)r * D + 8 * n + 2 * c;
      p[0] = o[n][2 * hh];
      p[1] = o[n][2 * hh + 1];
    }
  }
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
// memory. Three block barriers per hp heads. qstat: the JAX kernel's "qstat"
// numerics, the unnormalised P rounded to bf16 and the value sums divided
// by the rows' fp32 sums (each warp's, before they are summed).
template <int D>
__device__ void chunk_cross_attention(const bf16* q, int ldq, KvStream<D>& kv, int P, int hbase,
                                      int H, int S, float* red, float* part, bf16* out, int ldo,
                                      bf16* peer, bool qstat) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
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
      score_chunk<D>(s[i], qa, kh + ch * 4 * D, ch, nkeys);
      chunk_stats(s[i], red_h, ch);
    }
    for (int hq = 0; hq < hp; ++hq) kv.wait(2 * (h0 + hq) + 1);
    __syncthreads();  // the heads' V has landed; their K is consumed; the chunk statistics are in
    // pass 2: the rows' max and sum over every chunk, then P v
    float mx[2], den[2], sc[2];
    merge_stats(red_h, nch, mx, den);
    prob_scale(den, sc, qstat);
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
      pv_chunk<D>(o, s[i], vh + ch * 4 * D, mx, sc);
    }
    if (qstat) div_rows<D>(o, den);
    if (sub < nparts) store_partial<D>(o, P, part + (size_t)warp * P * D);
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

// The cross-attention at head_dim 128, with the numerics above, one head at
// a time: the head's K and V arrive as 32-key chunks (KvStream<D, true>:
// units 2 h nch .. 2 h nch + nch - 1 its K, the next nch its V), and warp w
// scores and sums chunks w and w + nwarps. A warp waits only on the
// mbarriers of the chunks it reads (each chunk is read by one warp); a
// chunk's buffer takes the unit nb after it once the block barrier after
// its reads is passed (the head's K buffers after its scores, its V after
// its value sums), so the whole K of a head (nch <= nb) is in flight before
// its scores and its first V chunks behind it. Two block barriers a head.
template <int D>
__device__ void chunk_cross_attention(const bf16* q, int ldq, KvStream<D, true>& kv, int P,
                                      int hbase, int H, int S, float* red, float* part, bf16* out,
                                      int ldo, bf16* peer, bool qstat) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nch = kv.Sp / 32, nkeys = S + 1, nparts = min(nch, nwarps);
  for (int h = 0; h < H; ++h) {
    const int k0 = 2 * h * nch, v0 = k0 + nch;  // the head's first K and V units
    uint32_t qa[D / 16][4];
    load_q<D, true>(qa, q + (hbase + h) * D, ldq, 0, P);
    float s[kMaxChunks][4][4];
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = warp + i * nwarps;
      if (ch >= nch) break;
      kv.wait(k0 + ch);
      score_chunk<D>(s[i], qa, reinterpret_cast<const uint4*>(kv.buffer(k0 + ch)), ch, nkeys);
      chunk_stats(s[i], red, ch);
    }
    __syncthreads();  // the head's K is consumed; the chunk statistics are in
    kv.issue_upto(v0 + kv.nb);
    float mx[2], den[2], sc[2];
    merge_stats(red, nch, mx, den);
    prob_scale(den, sc, qstat);
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i) {
      const int ch = warp + i * nwarps;
      if (ch >= nch) break;
      kv.wait(v0 + ch);
      pv_chunk<D>(o, s[i], reinterpret_cast<const uint4*>(kv.buffer(v0 + ch)), mx, sc);
    }
    if (qstat) div_rows<D>(o, den);
    if (warp < nparts) store_partial<D>(o, P, part + (size_t)warp * P * D);
    __syncthreads();  // the head's V is consumed; the partials are in
    kv.issue_upto(v0 + nch + kv.nb);
    for (int i = threadIdx.x; i < P * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float acc = 0.f;
      for (int w = 0; w < nparts; ++w) acc += part[((size_t)w * P + r) * D + d];
      const size_t o = (size_t)r * ldo + (hbase + h) * D + d;
      const bf16 v = __float2bfloat16(acc);
      out[o] = v;
      if (peer) peer[o] = v;
    }
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
// writes (the other block may still read the last layer's). qstat: the
// cross-attention's "qstat" numerics (chunk_cross_attention).
template <int D, int KC, int CS, class Epi>
__device__ __forceinline__ void decoder_pass(const PassArgs& a, const PassSmem& sm, const bf16* kv,
                                             int rank, unsigned& kv_seq, int pass, Epi epi,
                                             bool qstat = false) {
  constexpr int cs = CS;
  const int E = 32 * KC, L = a.L, H = a.H, Hl = H / cs, hbase = rank * Hl;
  const int P = a.P, Jp = a.Jp, S = a.S, Sp = a.Sp;
  const int lda = E + 8, ldw = 3 * E + 8, ldx = Jp + 8;
  const size_t kv_layer = (size_t)H * 2 * Sp * D;
  float* h = sm.h;
  bf16 *act = sm.act, *wide = sm.wide;
  // layer l's tensor k (per-layer width w): staged, or at head_dim 128 in global memory
  auto prm = [&](ChunkParam k, int l, int w) -> const bf16* {
    if constexpr (staged_params(D)) {
      return sm.params + chunk_param_offset(k, L, E, P) + l * w;
    } else {
      return param_src(a, k) + l * w;
    }
  };
  // embedding + positional encoding into the fp32 residual stream
  embed_product(sm.xin, ldx, P, Jp, a.emb_t, E, prm(kEmbB, 0, 0), EmbedEpi{h, prm(kPe, 0, 0), E});
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const size_t EE = (size_t)E * E;
    const bf16* ln_s = prm(kLnS, l, 3 * E);
    const bf16* ln_b = prm(kLnB, l, 3 * E);
    const bf16* kvl = kv + l * kv_layer + (size_t)hbase * 2 * Sp * D;
    // this layer's first K / V units start towards shared memory while
    // the block works on the self-attention (head_dim 128: 32-key chunks)
    constexpr bool chunks = D == kWideHead;
    KvStream<D, chunks> kvs{kvl, sm.ring, sm.bars, Sp, a.nbuf, 2 * Hl * (chunks ? Sp / 32 : 1), 0,
                            kv_seq};
    kv_seq += kvs.units;
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
                             cs > 1 ? cluster_peer(xa, rank ^ 1) : nullptr, qstat);
    robot_sync(cs);
    rows_product<KC>(xa, lda, P, a.co_t + l * EE, E, prm(kCoB, l, E), AddTo{h, E});
    __syncthreads();
    // MLP
    ln_bf16_rows(h, P, E, ln_s + 2 * E, ln_b + 2 * E, act, lda);
    __syncthreads();
    rows_product<KC>(act, lda, P, a.m1_t + l * EE, E, prm(kM1B, l, E), GeluBf16<kGeluExact>{wide, ldw});
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

// The chunk samplers' output epilogue: eps(m, n) -> the solver update of
// the carry x and the DPM-Solver++ x0 cache (fp32) and the next pass's bf16
// embedding input
struct SolverEpi {
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

// The head dimension of a decoder-pass instance (32, 64 or 128), else 0.
__host__ inline int pass_head_dim(int E, int H) {
  return H > 0 && E == kWideHead * H ? kWideHead : head_dim(E, H);
}

// The shapes both kernels take (the wrappers' check_kernel_shapes raises
// before a launch gets here): threads 512, or 256 at head_dim 32; blocks a
// robot 1 or 2; head_dim 128 at hidden 512 only, its 256 threads, at most
// 10 chunk steps (its shared memory) and kChunkRing 32-key chunks.
__host__ inline bool pass_shape_ok(const PassArgs& a, int D, int threads, int cs) {
  const bool shape = D == kWideHead
                         ? a.E == 512 && threads == kWideThreads && a.P <= 10 &&
                               a.Sp <= 32 * kChunkRing
                         : (threads == kPassThreads || threads == 256) &&
                               a.Sp <= 32 * kMaxChunks * (threads / 32) &&
                               (a.E == 128 || a.E == 256) && (D == 64 || a.E == 128);
  return D != 0 && shape && a.P >= 1 && a.P <= 16 && (a.Jp == 32 || a.Jp == 64) &&
         a.Jp >= a.J && a.J % 2 == 0 && a.Sp == (a.S + 1 + 31) / 32 * 32 && (cs == 1 || cs == 2) &&
         a.H % cs == 0;
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
