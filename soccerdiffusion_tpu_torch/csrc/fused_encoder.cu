// Fused context encoder: every proprioceptive encoder stack of a robot,
// one thread block per (robot, stack), plus the game-state token as a row
// gather, written straight into the concatenated (B, S, E) context.
//
// Replaces soccerdiffusion_tpu/ops/fused_encoder.py:
// FusedContextEncoder.encode (_make_encoder_kernel).
//
// Bound on the H100: per (robot, stack) at T=100 tokens, E=128 and two
// layers the block does ~50 MFLOP against ~1 KB of input and 26 KB of
// output, with ~0.4 MB of weights shared by all blocks (L2-resident) --
// compute- and latency-bound in shared memory, not by HBM (measured: 20 ms
// at B=1024 on an H100 80GB HBM3 at 700 W, ~7.6 TFLOP/s of scalar fp32
// math, PERF.md). Design: the
// whole stack runs in one block with the fp32 residual (T x E), the
// LayerNorm / attention output (T x E) and q|k|v (T x 3E bf16, odd word
// stride so warp lanes reading different tokens hit different banks)
// resident in ~176 KB of dynamic shared memory; no TPU-style 8-row padding
// or key masks (a block handles any T <= 128), four 32-lane heads instead
// of lane-masked head stacking, erff for the exact GELU.
#include "common.cuh"

namespace sd {

constexpr int kMaxStacks = 3;

struct EncoderStack {
  const bf16* x;      // (B, T, Cin) patch-folded input
  const bf16* emb_w;  // (Cin, E) patch-conv kernel
  const bf16* emb_b;  // (E)
  const bf16* pos;    // (T, E)
  const bf16* qkv_w;  // (L, E, 3E)
  const bf16* qkv_b;  // (L, 3E)
  const bf16* o_w;    // (L, E, E)
  const bf16* o_b;    // (L, E)
  const bf16* ln_s;   // (L, 2, E) norm1 / norm2
  const bf16* ln_b;   // (L, 2, E)
  const bf16* m1_w;   // (L, E, E)
  const bf16* m1_b;   // (L, E)
  const bf16* m2_w;   // (L, E, E)
  const bf16* m2_b;   // (L, E)
  int tokens, in_dim, layers, offset;  // offset: first context row of this stack
};

struct EncoderArgs {
  EncoderStack st[kMaxStacks];
  const int* game_state;  // (B,) or null
  const bf16* gs_table;   // (num_states, E) or null
  bf16* out;              // (B, S, E)
  int B, S, E, H;
};

__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

// floats of shared memory for a stack of T tokens
__host__ __device__ inline size_t encoder_smem_floats(int T, int E, int in_dim) {
  const size_t qkv_floats = ((size_t)T * (3 * E + 2) + 1) / 2;  // bf16 q|k|v
  const size_t big = qkv_floats > (size_t)T * E ? qkv_floats : (size_t)T * E;
  return (size_t)T * E + (size_t)T * max_i(E, (in_dim + 3) & ~3) + ((big + 3) & ~(size_t)3);
}

__global__ void __launch_bounds__(kThreads) fused_encoder_kernel(EncoderArgs a) {
  extern __shared__ float4 smem4[];
  const EncoderStack st = a.st[blockIdx.y];
  const int b = blockIdx.x, E = a.E, T = st.tokens, Cin = st.in_dim, C4 = (Cin + 3) & ~3;
  const int LDQ = 3 * E + 2;  // bf16 elements: an odd number of 32-bit words
  float* h = reinterpret_cast<float*>(smem4);  // (T, E) fp32 residual
  float* act = h + T * E;                      // (T, max(E, C4)) rounded matmul input
  float* big = act + T * max_i(E, C4);         // q|k|v (bf16) or the MLP hidden (fp32)
  bf16* qkv = reinterpret_cast<bf16*>(big);

  const bf16* x = st.x + (size_t)b * T * Cin;
  for (int i = threadIdx.x; i < T * Cin; i += blockDim.x) act[(i / Cin) * C4 + i % Cin] = tof(x[i]);
  __syncthreads();
  dense<8, 2>(act, C4, T, Cin, st.emb_w, E, st.emb_b, EmbedEpi{h, st.pos, E});
  __syncthreads();
  for (int l = 0; l < st.layers; ++l) {
    const size_t EE = (size_t)E * E;
    const bf16* ln_s = st.ln_s + (size_t)l * 2 * E;
    const bf16* ln_b = st.ln_b + (size_t)l * 2 * E;
    layer_norm_rows(h, E, T, E, ln_s, ln_b, act, E);
    __syncthreads();
    dense<8, 2>(act, E, T, E, st.qkv_w + l * 3 * EE, 3 * E, st.qkv_b + (size_t)l * 3 * E,
                StoreRoundBf16{qkv, LDQ});
    __syncthreads();
    self_attention<32>(qkv, LDQ, T, E, a.H, act, E);
    __syncthreads();
    dense<8, 2>(act, E, T, E, st.o_w + l * EE, E, st.o_b + (size_t)l * E, AddTo{h, E});
    __syncthreads();
    layer_norm_rows(h, E, T, E, ln_s + E, ln_b + E, act, E);
    __syncthreads();
    dense<8, 2>(act, E, T, E, st.m1_w + l * EE, E, st.m1_b + (size_t)l * E, StoreGeluRound{big, E});
    __syncthreads();
    dense<8, 2>(big, E, T, E, st.m2_w + l * EE, E, st.m2_b + (size_t)l * E, AddTo{h, E});
    __syncthreads();
  }
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
// ints: n_stacks, B, S, E, H, then per stack tokens, in_dim, layers, offset
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
    const int* q = ints + 5 + 4 * s;
    a.st[s] = EncoderStack{p[0], p[1], p[2], p[3], p[4],  p[5],  p[6], p[7],
                           p[8], p[9], p[10], p[11], p[12], p[13], q[0], q[1], q[2], q[3]};
    const size_t need = encoder_smem_floats(q[0], a.E, q[1]) * sizeof(float);
    smem = need > smem ? need : smem;
  }
  a.game_state = static_cast<const int*>(ptrs[14 * n]);
  a.gs_table = static_cast<const bf16*>(ptrs[14 * n + 1]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[14 * n + 2]));
  cudaError_t err = cudaFuncSetAttribute(fused_encoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_encoder_kernel<<<dim3(a.B, n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
