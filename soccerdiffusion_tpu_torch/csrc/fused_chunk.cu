// Whole-chunk sampler: every step of the T-step DDIM / DPM-Solver++ chunk
// for one robot in one thread block, in one launch, on the tensor cores.
//
// Replaces soccerdiffusion_tpu/ops/fused_chunk.py: FusedChunkSampler.sample
// (_make_chunk_kernel), its unquantised forms: the default "kstat" (and
// group_robots > 1, whose block-diagonal masks give the same function), and
// "qstat" (ChunkArgs::qstat, at run time: the step token's K / V as key S
// as ever, the unnormalised probabilities rounded to bf16 before the value
// product, the fp32 divide after it). The int8 form is fused_chunk_int8.cu.
//
// Instances for head_dim 32 (h128), 64 (E=128 or 256, the vit_flagship
// model at 256) and 128 (E=512, the larger_model configuration: its own
// shared-memory plan and 256-thread block, decoder_pass.cuh), templated on
// the head dim and on E / 32. At E=512 the context K/V scratch is 5.2 MB a
// robot (L=8, S=311; 335 MB at B=64), the 8 layers' pass weights 33.5 MB,
// read by every block at every step.
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
// head_dim 64 B=64 on an H100 80GB HBM3 at 700 W).
//
// The pass itself (the products, both attentions, the K / V stream, the
// staged parameters, the launch shapes) is decoder_pass.cuh's, shared with
// the serving denoiser (fused_denoise.cu); this file holds what is the
// chunk's own: the once-per-chunk K/V projection, the step loop and the
// solver update. Design:
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
//     blocks on an SM (ops/fused_denoise.py:block_threads);
//   * while the card has two SMs per robot (B <= 66 on 132 SMs), a cluster
//     of two blocks per robot (CS = 2, ops/fused_denoise.py:cluster_size):
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
// Shared memory (pass_smem_bytes): 137 KB at h128 (P=10, J=20, S=301; 87 KB
// with 8 warps, 142 KB in a cluster), 189 KB at E=256, S=311 (199 KB in a
// cluster). The x / x0cache solver carry and
// the fp32 residual stay in shared memory across the T steps; the (T, 5)
// [A, B, C, P, Q] table drives DDIM (C = 0) and DPM-Solver++(2M) with one
// update rule.
#include "decoder_pass.cuh"

namespace sd {

struct ChunkArgs : PassArgs {
  const bf16* kv_t;     // (2 L E, E): row ((l H + h) 2 + sel) D + d, sel 0: wck, 1: wcv
  const bf16* kv_b;     // (2 L E) alike
  const float* noise;   // (B, P, J) fp32
  const bf16* context;  // (B, S, E)
  const bf16* stk;      // (T, L, E) per-step step-token cross K
  const bf16* stv;      // (T, L, E)
  const float* coef;    // (T, 5) [A, B, C, P, Q]
  bf16* kv;             // scratch (B, L, H, 2, Sp D) in fragment order
  float* out;           // (B, P, J) fp32
  int T;
  int qstat;            // 1: the "qstat" cross-attention numerics
};

struct KvFragEpi {  // projected column n of context row m -> the scratch
  bf16* kv;
  int D, Sp, lhs0;
  __device__ void operator()(int m, int n, float v) const {
    const int d = n % D, lhs = lhs0 + n / D;  // lhs = (l H + h) 2 + sel
    bf16* blk = kv + (size_t)lhs * Sp * D;
    blk[(lhs & 1) ? vfrag(m, d, D) : kfrag(m, d, D)] = __float2bfloat16(v);
  }
};

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
__global__ void __launch_bounds__(D == kWideHead ? kWideThreads : kPassThreads)
    fused_chunk_kernel(ChunkArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int cs = CS;
  const int rank = blockIdx.x % cs, b = blockIdx.x / cs;
  const int L = a.L, H = a.H, Hl = H / cs, hbase = rank * Hl;
  const int P = a.P, J = a.J, Jp = a.Jp;
  const int S = a.S, Sp = a.Sp, PJ = P * J;
  const int ldx = Jp + 8;
  const PassSmem sm = carve_pass_smem<D>(smem4, a, 2 * r4((size_t)PJ));
  float* x = sm.carry;  // (P, J) solver carry
  float* x0c = x + r4((size_t)PJ);
  bf16* xin = sm.xin;
  bf16* kv = a.kv + (size_t)b * L * H * 2 * Sp * D;
  init_kv_ring(sm.bars, a.nbuf);
  if constexpr (staged_params(D)) stage_params(a, sm.params);

  // once per chunk: this robot's context K/V for every layer and the
  // block's heads, in fragment order; keys past S are zero (key S: the step
  // token, per step)
  project_context_kv<D>(a, a.context + (size_t)b * S * a.E, hbase, Hl, kv);
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
    // the step token: key S of every layer's K and V (the projection's
    // writes and these before the bulk copies read the scratch)
    write_step_token<D>(kv, a.stk + (size_t)t * L * a.E, a.stv + (size_t)t * L * a.E, L, H, hbase,
                        Hl, S, Sp);
    // the pass; the solver update in its output product's epilogue
    const float* cf = a.coef + 5 * t;
    decoder_pass<D, KC, CS>(a, sm, kv, rank, kv_seq, t,
                            SolverEpi{x, x0c, xin, J, ldx, cf[0], cf[1], cf[2], cf[3], cf[4]},
                            a.qstat != 0);
  }
  if (rank == 0)
    for (int i = threadIdx.x; i < PJ; i += blockDim.x) a.out[(size_t)b * PJ + i] = x[i];
}

}  // namespace sd

// ptrs: the 19 PassArgs weight pointers (declaration order: emb_t ..
//       fc_b), kv_t, kv_b, noise, context, stk, stv, coef, kv scratch, out
// ints: L, E, H, P, J, Jp, B, S, Sp, T, threads per block (512, or 256:
//       two blocks on an SM at head_dim 32, or head_dim 128's block), blocks
//       a robot (1, or 2: a cluster of two splitting the heads), qstat (0 / 1)
extern "C" int sd_fused_chunk(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  ChunkArgs a;
  const bf16** w = &a.emb_t;  // the 19 pass weights in declaration order
  for (int i = 0; i < kPassWeights; ++i) w[i] = static_cast<const bf16*>(ptrs[i]);
  a.kv_t = static_cast<const bf16*>(ptrs[19]);
  a.kv_b = static_cast<const bf16*>(ptrs[20]);
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
  const int threads = ints[10], cs = ints[11], D = pass_head_dim(a.E, a.H);
  if (!pass_shape_ok(a, D, threads, cs)) return (int)cudaErrorInvalidValue;
  a.nbuf = kv_buffers(D, threads);
  a.qstat = ints[12];
  void (*kernel)(ChunkArgs);
  if (D == 32) {
    kernel = cs == 1 ? fused_chunk_kernel<32, 4, 1> : fused_chunk_kernel<32, 4, 2>;
  } else if (D == kWideHead) {
    kernel = cs == 1 ? fused_chunk_kernel<128, 16, 1> : fused_chunk_kernel<128, 16, 2>;
  } else if (a.E == 128) {
    kernel = cs == 1 ? fused_chunk_kernel<64, 4, 1> : fused_chunk_kernel<64, 4, 2>;
  } else {
    kernel = cs == 1 ? fused_chunk_kernel<64, 8, 1> : fused_chunk_kernel<64, 8, 2>;
  }
  const size_t smem = pass_smem_bytes(a.L, a.P, a.E, a.H, a.J, a.Jp, a.Sp, threads, cs,
                                      2 * r4((size_t)a.P * a.J));
  return launch_robots(kernel, a, threads, cs, smem, stream);
}
