// Whole-chunk sampler: every step of the T-step DDIM / DPM-Solver++ chunk
// for one robot in one thread block, in one launch.
//
// Replaces soccerdiffusion_tpu/ops/fused_chunk.py: FusedChunkSampler.sample
// (_make_chunk_kernel), its default "kstat", group_robots=1, unquantised
// form.
//
// Instances for head_dim 32 (h128) and 64 (h256, the vit_flagship model).
//
// Bound on the H100: the context K/V of one robot (L x 2 x S x E bf16 =
// 616 KB at L=4, S=301, E=128; 1.27 MB at S=311, E=256) do not fit in the
// 227 KB of shared memory the TPU kernel's VMEM scratch held them in, and at
// B=1024 the set is 631 MB, beyond the 50 MB L2. So the block projects them once per chunk
// into a global scratch (allocated by the wrapper) and re-reads them at
// each step from L2 / HBM: T x 616 KB per robot, ~19 GB per B=1024 chunk,
// a 5.6 ms floor at 3.35 TB/s. The per-step scalar fp32 math is slower and
// bounds the kernel: 67 ms per B=1024 chunk on an H100 80GB HBM3 at 700 W,
// ~9 TFLOP/s; at head_dim 64 and B=64 (64 blocks on 132 SMs) 36.6 ms,
// ~3.4 TFLOP/s (PERF.md). The x / x0cache solver carry, the fp32 residual
// and all per-step activations stay in shared memory across the T steps;
// the (T, 5) [A, B, C, P, Q] table drives DDIM (C = 0) and DPM-Solver++(2M)
// with one update rule.
#include "decoder_layer.cuh"

namespace sd {

struct ChunkArgs {
  DecoderWeights w;
  const bf16* ckv_w;    // (E, 2 L E): layer l K at columns [2lE, 2lE+E), V at [2lE+E, 2lE+2E)
  const bf16* ckv_b;    // (2 L E)
  const float* noise;   // (B, P, J) fp32
  const bf16* context;  // (B, S, E)
  const bf16* stk;      // (T, L, E) per-step step-token cross K
  const bf16* stv;      // (T, L, E)
  const float* coef;    // (T, 5) [A, B, C, P, Q]
  bf16* kv;             // scratch (B, L, 2, S, E)
  float* out;           // (B, P, J) fp32
  int B, S, T;
};

constexpr int kProjRows = 64;  // most context rows per projection tile

struct KvEpi {  // projected context column n of row m -> scratch[l][k|v][r0 + m]
  bf16* kv;
  int r0, S, E;
  __device__ void operator()(int m, int n, float v) const {
    const int l = n / (2 * E), sel = (n / E) & 1, col = n % E;
    kv[(((size_t)l * 2 + sel) * S + r0 + m) * E + col] = __float2bfloat16(v);
  }
};

struct StoreF32 {
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v) const { out[m * ld + n] = v; }
};

__host__ __device__ inline size_t chunk_smem_floats(int P, int E, int H, int J, int S) {
  return decoder_smem_floats(P, E, H, J, S) + 3 * (size_t)P * J;
}

template <int D>
__global__ void __launch_bounds__(kThreads) fused_chunk_kernel(ChunkArgs a) {
  extern __shared__ float4 smem4[];
  const DecoderWeights& w = a.w;
  const int b = blockIdx.x, E = w.E, L = w.L, S = a.S, PJ = w.P * w.J;
  float* base = reinterpret_cast<float*>(smem4);
  const DecoderSmem sm = carve_decoder_smem(base, w.P, E, w.H, w.J, S);
  float* x = base + decoder_smem_floats(w.P, E, w.H, w.J, S);
  float* x0c = x + PJ;
  float* eps = x0c + PJ;
  bf16* kv = a.kv + (size_t)b * L * 2 * S * E;

  // once per chunk: project this robot's context K/V for every layer; the
  // staging tile reuses the score block
  const bf16* ctx = a.context + (size_t)b * S * E;
  const int tile = min(kProjRows, w.H * w.P * (S + 1) / E);
  for (int r0 = 0; r0 < S; r0 += tile) {
    const int rows = min(tile, S - r0);
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) sm.sc[i] = tof(ctx[(size_t)r0 * E + i]);
    __syncthreads();
    dense<8, 2>(sm.sc, E, rows, E, a.ckv_w, 2 * L * E, a.ckv_b, KvEpi{kv, r0, S, E});
    __syncthreads();
  }

  for (int i = threadIdx.x; i < PJ; i += blockDim.x) {
    x[i] = a.noise[(size_t)b * PJ + i];
    x0c[i] = 0.f;
  }
  __syncthreads();
  const size_t layer_stride = 2 * (size_t)S * E;
  for (int t = 0; t < a.T; ++t) {
    const size_t st = (size_t)t * L * E;
    decoder_pass<D>(w, sm, x, kv, kv + (size_t)S * E, layer_stride, a.stk + st, a.stv + st, S,
                    StoreF32{eps, w.J});
    const float* c = a.coef + 5 * t;
    const float cA = c[0], cB = c[1], cC = c[2], cP = c[3], cQ = c[4];
    for (int i = threadIdx.x; i < PJ; i += blockDim.x) {
      const float xi = x[i], ei = eps[i];
      x[i] = cA * xi + cB * ei + cC * x0c[i];
      x0c[i] = cP * xi + cQ * ei;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < PJ; i += blockDim.x) a.out[(size_t)b * PJ + i] = x[i];
}

}  // namespace sd

// ptrs: 19 DecoderWeights pointers (declaration order), ckv_w, ckv_b, noise,
//       context, stk, stv, coef, kv scratch, out
// ints: L, E, H, P, J, B, S, T
extern "C" int sd_fused_chunk(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  ChunkArgs a;
  const bf16* const* wp = reinterpret_cast<const bf16* const*>(ptrs);
  a.w = DecoderWeights{wp[0],  wp[1],  wp[2],  wp[3],  wp[4],  wp[5],  wp[6],
                       wp[7],  wp[8],  wp[9],  wp[10], wp[11], wp[12], wp[13],
                       wp[14], wp[15], wp[16], wp[17], wp[18], ints[0], ints[1],
                       ints[2], ints[3], ints[4]};
  a.ckv_w = static_cast<const bf16*>(ptrs[19]);
  a.ckv_b = static_cast<const bf16*>(ptrs[20]);
  a.noise = static_cast<const float*>(ptrs[21]);
  a.context = static_cast<const bf16*>(ptrs[22]);
  a.stk = static_cast<const bf16*>(ptrs[23]);
  a.stv = static_cast<const bf16*>(ptrs[24]);
  a.coef = static_cast<const float*>(ptrs[25]);
  a.kv = static_cast<bf16*>(const_cast<void*>(ptrs[26]));
  a.out = static_cast<float*>(const_cast<void*>(ptrs[27]));
  a.B = ints[5];
  a.S = ints[6];
  a.T = ints[7];
  if (a.w.H * a.w.P * (a.S + 1) < a.w.E) return (int)cudaErrorInvalidValue;  // no staging room
  const int D = head_dim(a.w.E, a.w.H);
  if (D == 0) return (int)cudaErrorInvalidValue;
  auto kernel = D == 32 ? fused_chunk_kernel<32> : fused_chunk_kernel<64>;
  const size_t smem = chunk_smem_floats(a.w.P, a.w.E, a.w.H, a.w.J, a.S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
