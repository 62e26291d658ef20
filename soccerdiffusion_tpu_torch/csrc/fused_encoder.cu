// Fused context encoder: every proprioceptive encoder stack of a robot,
// one thread block per (robot, stack), plus the game-state token as a row
// gather, written straight into the concatenated (B, S, E) context.
//
// Replaces soccerdiffusion_tpu/ops/fused_encoder.py:
// FusedContextEncoder.encode (_make_encoder_kernel).
//
// Bound on the H100: per (robot, stack) at T=100 tokens, E=128 and two
// layers the block does ~50 MFLOP against ~4 KB of input and 26 KB of
// output, with ~0.4 MB of weights shared by all blocks (L2-resident): 0.16
// ms of bf16 tensor-core work at B=1024 (three stacks), compute- and
// latency-bound in shared memory, not by HBM. The first port did every
// product as scalar fp32 FMAs (19.9 ms at B=1024 on an H100 80GB HBM3 at
// 700 W, ~7.6 TFLOP/s, slower than its own plain version; PERF.md). Design
// now: each layer is encoder_layer.cuh:layer_fwd_smem<32, exact GELU>, the
// tensor-core forward the training stack and the ViT block share (16 warps,
// mma.sync products over 64-row warp items, attention per (head, 16-row
// tile) with the scores in registers), whose rounding points are
// encode_plain's: bf16 LayerNorm outputs, q/k/v, head outputs and GELU
// output, bf16(P) before the value sum, the fp32 residual. The patch-conv
// embedding is an mma_dense product too, its input (T, patch x channels)
// staged in shared memory with the reduction padded by zero columns to a
// multiple of 8 (the weights packed to match, ops/fused_encoder.py). The
// fp32 residual stays in shared memory: T E fp32 + layer_fwd_smem's bf16
// operands (fwd_smem_bytes) = 157 KB at T=100, E=128 (one block per SM);
// block barriers per layer: 7 (layer_fwd_smem), plus 2 around the
// embedding. Keys past T are masked at the tile edges (no TPU-style 8-row
// padding), erff for the exact GELU.
#include "encoder_layer.cuh"

namespace sd {

constexpr int kMaxStacks = 3;

struct EncoderStack {
  const bf16* x;      // (B, T, Cin) patch-folded input
  const bf16* emb_t;  // (E, Cp) patch-conv kernel transposed, columns Cin .. Cp - 1 zero
  const bf16* emb_b;  // (E)
  const bf16* pos;    // (T, E)
  const bf16* qkv_t;  // (L, 3E, E) transposed (out, in)
  const bf16* qkv_b;  // (L, 3E)
  const bf16* o_t;    // (L, E, E)
  const bf16* o_b;    // (L, E)
  const bf16* ln_s;   // (L, 2, E) norm1 / norm2
  const bf16* ln_b;   // (L, 2, E)
  const bf16* m1_t;   // (L, E, E)
  const bf16* m1_b;   // (L, E)
  const bf16* m2_t;   // (L, E, E)
  const bf16* m2_b;   // (L, E)
  int tokens, in_dim, in_pad, layers, offset;  // offset: first context row of this stack
};

struct EncoderArgs {
  EncoderStack st[kMaxStacks];
  const int* game_state;  // (B,) or null
  const bf16* gs_table;   // (num_states, E) or null
  bf16* out;              // (B, S, E)
  int B, S, E, H;
};

// shared-memory bytes for a stack of T tokens: the fp32 residual and
// layer_fwd_smem's operands (whose q|k|v region first holds the staged input)
__host__ __device__ inline size_t encoder_smem_bytes(int T, int E) {
  return 4 * (size_t)T * E + fwd_smem_bytes(T, E);
}

__device__ inline EncLayer encoder_layer(const EncoderStack& st, int l, int E) {
  const size_t EE = (size_t)E * E;
  EncLayer w = {};
  w.g1 = st.ln_s + (size_t)l * 2 * E;
  w.be1 = st.ln_b + (size_t)l * 2 * E;
  w.g2 = w.g1 + E;
  w.be2 = w.be1 + E;
  w.wqkv_t = st.qkv_t + l * 3 * EE;
  w.bqkv = st.qkv_b + (size_t)l * 3 * E;
  w.wo_t = st.o_t + l * EE;
  w.bo = st.o_b + (size_t)l * E;
  w.w1_t = st.m1_t + l * EE;
  w.b1 = st.m1_b + (size_t)l * E;
  w.w2_t = st.m2_t + l * EE;
  w.b2 = st.m2_b + (size_t)l * E;
  return w;
}

__global__ void __launch_bounds__(kFwdThreads) fused_encoder_kernel(EncoderArgs a) {
  extern __shared__ float4 smem4[];
  const EncoderStack st = a.st[blockIdx.y];
  const int b = blockIdx.x, E = a.E, T = st.tokens, Cin = st.in_dim, Cp = st.in_pad;
  float* h = reinterpret_cast<float*>(smem4);      // (T, E) fp32 residual
  bf16* act = reinterpret_cast<bf16*>(h + T * E);  // (T, E + 8)
  bf16* qkv = act + T * (E + 8);                   // (T, 3E + 8); first the input (T, Cp)

  const bf16* x = st.x + (size_t)b * T * Cin;
  for (int i = threadIdx.x; i < T * Cp; i += blockDim.x) {
    const int t = i / Cp, c = i % Cp;
    qkv[i] = c < Cin ? x[t * Cin + c] : __float2bfloat16(0.f);
  }
  __syncthreads();
  mma_dense<4, 2>(qkv, Cp, T, Cp, st.emb_t, Cp, E, st.emb_b, EmbedEpi{h, st.pos, E});
  __syncthreads();
  for (int l = 0; l < st.layers; ++l)
    layer_fwd_smem<32, kGeluExact>(encoder_layer(st, l, E), h, h, act, qkv, T, E, E, a.H);
  bf16* out = a.out + ((size_t)b * a.S + st.offset) * E;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) out[i] = __float2bfloat16(h[i]);
  if (blockIdx.y == 0 && a.gs_table != nullptr) {
    const bf16* row = a.gs_table + (size_t)a.game_state[b] * E;
    bf16* gs_out = a.out + ((size_t)b * a.S + a.S - 1) * E;
    for (int i = threadIdx.x; i < E; i += blockDim.x) gs_out[i] = row[i];
  }
}

}  // namespace sd

// ptrs: per stack 14 pointers (EncoderStack declaration order), then
//       game_state, gs_table, out (game_state / gs_table may be null)
// ints: n_stacks, B, S, E, H, then per stack tokens, in_dim, in_pad, layers, offset
extern "C" int sd_fused_encoder(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  EncoderArgs a = {};
  const int n = ints[0];
  if (n < 1 || n > kMaxStacks) return (int)cudaErrorInvalidValue;
  a.B = ints[1];
  a.S = ints[2];
  a.E = ints[3];
  a.H = ints[4];
  if (a.E != 32 * a.H) return (int)cudaErrorInvalidValue;  // head_dim 32 only
  size_t smem = 0;
  for (int s = 0; s < n; ++s) {
    const bf16* const* p = reinterpret_cast<const bf16* const*>(ptrs) + 14 * s;
    const int* q = ints + 5 + 5 * s;
    a.st[s] = EncoderStack{p[0], p[1], p[2], p[3], p[4],  p[5],  p[6], p[7],
                           p[8], p[9], p[10], p[11], p[12], p[13], q[0], q[1], q[2], q[3], q[4]};
    // the staged input fits the q|k|v region; Cp a multiple of 8 (ldmatrix rows)
    if (q[0] < 1 || q[0] > 128 || q[2] % 8 != 0 || q[2] < q[1] || q[2] > 3 * a.E + 8)
      return (int)cudaErrorInvalidValue;
    const size_t need = encoder_smem_bytes(q[0], a.E);
    smem = need > smem ? need : smem;
  }
  a.game_state = static_cast<const int*>(ptrs[14 * n]);
  a.gs_table = static_cast<const bf16*>(ptrs[14 * n + 1]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[14 * n + 2]));
  cudaError_t err = cudaFuncSetAttribute(fused_encoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_encoder_kernel<<<dim3(a.B, n), kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
