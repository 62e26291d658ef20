// Fused denoiser: one pass of the whole cross-attending decoder against
// pre-projected context K/V for each robot, on the tensor cores.
//
// Replaces soccerdiffusion_tpu/ops/fused_denoise.py: FusedDenoiser.__call__
// and FusedDenoiser._call_with_precomputed (_make_kernel). Both call sites
// share this kernel; `has_coefs` selects the DDIM epilogue (x_prev instead
// of eps). Instances for head_dim 32 (h128), 64 (E=128 or 256, the
// vit_flagship model at 256) and 128 (E=512, the larger_model
// configuration, on decoder_pass.cuh's head_dim-128 plan), templated on the
// head dim, on E / 32 and on the blocks a robot.
//
// Bound on the H100: a pass reads the robot's context K/V (L x 2 x S x E
// bf16 = 616 KB at L=4, S=301, E=128: 631 MB at B=1024, a 0.19 ms floor at
// 3.35 TB/s) against ~17 MFLOP of products; at B=1024 those bytes bound
// it, elsewhere the per-robot chain of ~70-95 short dependent phases of
// the pass (L2 round trips of the weights, block barriers), as in the
// chunk sampler (tools/chunk_phase_clock.py --kernel denoise, PERF.md). The
// first port ran the pass as scalar fp32 FMAs, one 256-thread block a robot
// (2.26 ms at h128 B=1024, 1.19 ms at head_dim 64 B=64 on an H100 80GB HBM3
// at 700 W).
//
// Design: the pass is the chunk sampler's (decoder_pass.cuh): every product
// on the tensor cores (rows_product over the serving weights packed once,
// transposed), the self-attention in registers, the cross-attention
// streaming each (layer, head)'s K and V into a shared-memory ring as one
// bulk copy (TMA) on an mbarrier, the launch shapes of the sampler (16
// warps a robot; two 8-warp blocks an SM past 132 robots at head_dim 32; a
// 2-block cluster splitting the heads at B <= 66). The K/V come packed by
// the wrapper (ops/fused_denoise.py:pack_context_kv) in the order the
// chunk kernel's scratch holds them, (B, L, H, 2, Sp D) in mma-fragment
// order with keys past S zero, so KvStream reads them unchanged; each launch
// writes the shared step token's key and value into key S of its robot's
// K/V (write_step_token), so they enter the same softmax as column S. The
// output product's epilogue (DenoiseEpi) writes eps or x_prev.
//
// The pack itself is a kernel of this file too (pack_context_kv_kernel, a
// launch per layer): a block per (32 keys, K | V, robot) reads the keys' E
// columns into shared memory with 16-byte loads and writes each head's 32 x
// D fragment-ordered elements, a contiguous run of the unit, with 16-byte
// stores (PyTorch's index copies reached under a third of the HBM rate).
#include "decoder_pass.cuh"

namespace sd {

struct DenoiseArgs : PassArgs {
  const float* noisy;  // (B, P, J) fp32
  bf16* kv;            // packed context K/V (B, L, H, 2, Sp D); key S written here
  const bf16* stk;     // (L, E) step-token cross K, shared by all robots
  const bf16* stv;     // (L, E)
  float* out;          // (B, P, J) fp32: eps, or x_prev with coefs
  float c0, c1, c2, c3;  // [1/sqrt(abar_t), sqrt(1-abar_t), sqrt(abar_prev), sqrt(1-abar_prev)]
  int has_coefs;
};

struct DenoiseEpi {  // eps(m, n) -> out: eps, or the DDIM step in the plain version's order
  float* out;        // null: the other block of a cluster writes the robot's output
  const float* x;
  float c0, c1, c2, c3;
  int J, has_coefs;
  __device__ void operator()(int m, int n, float eps) const {
    if (!out) return;
    const int i = m * J + n;
    out[i] = has_coefs ? c2 * ((x[i] - c1 * eps) * c0) + c3 * eps : eps;
  }
};

// CS blocks a robot: 1, or a cluster of 2 that splits its heads
template <int D, int KC, int CS>
__global__ void __launch_bounds__(D == kWideHead ? kWideThreads : kPassThreads)
    fused_denoise_kernel(DenoiseArgs a) {
  extern __shared__ float4 smem4[];
  const int rank = blockIdx.x % CS, b = blockIdx.x / CS;
  const int Hl = a.H / CS, hbase = rank * Hl;
  const int P = a.P, J = a.J, Jp = a.Jp, PJ = P * J, ldx = Jp + 8;
  const PassSmem sm = carve_pass_smem<D>(smem4, a, 0);
  bf16* kv = a.kv + (size_t)b * a.L * a.H * 2 * a.Sp * D;
  const float* x = a.noisy + (size_t)b * PJ;
  init_kv_ring(sm.bars, a.nbuf);
  if constexpr (staged_params(D)) stage_params(a, sm.params);
  write_step_token<D>(kv, a.stk, a.stv, a.L, a.H, hbase, Hl, a.S, a.Sp);
  for (int i = threadIdx.x; i < P * Jp; i += blockDim.x) {
    const int m = i / Jp, j = i % Jp;
    sm.xin[m * ldx + j] = __float2bfloat16(j < J ? x[m * J + j] : 0.f);
  }
  robot_sync(CS);  // a cluster's blocks both run before either writes the other's shared memory
  unsigned kv_seq = 0;
  decoder_pass<D, KC, CS>(a, sm, kv, rank, kv_seq, 0,
                          DenoiseEpi{rank == 0 ? a.out + (size_t)b * PJ : nullptr, x, a.c0, a.c1,
                                     a.c2, a.c3, J, a.has_coefs});
}

struct PackArgs {
  const bf16* k;  // layer l's K (B, S, H, D)
  const bf16* v;  // its V
  bf16* kv;       // (B, L, H, 2, Sp D)
  int L, l, H, S, Sp;
};

// Grid (Sp / 32, 2, B): keys 32 x .. 32 x + 31 of layer l's K (y = 0) or V
// (y = 1) of robot z, zero at keys S .. Sp - 1. E <= 256 columns, or 512 at
// head_dim 128.
template <int D>
__global__ void __launch_bounds__(256) pack_context_kv_kernel(PackArgs a) {
  constexpr int kMaxE = D == kWideHead ? 512 : 256;
  __shared__ uint4 tile4[32 * kMaxE / 8];  // 32 keys x E <= kMaxE columns
  const bf16* tile = reinterpret_cast<const bf16*>(tile4);
  const int ch = blockIdx.x, sel = blockIdx.y, b = blockIdx.z;
  const int E = a.H * D, E8 = E / 8;
  const uint4* src = reinterpret_cast<const uint4*>((sel ? a.v : a.k) + (size_t)b * a.S * E);
  for (int i = threadIdx.x; i < 32 * E8; i += blockDim.x) {
    const int s = 32 * ch + i / E8;
    tile4[i] = s < a.S ? src[(size_t)s * E8 + i % E8] : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  constexpr int kWords = 32 * D / 8;  // 16-byte words of a head's 32 keys
  for (int w = threadIdx.x; w < a.H * kWords; w += blockDim.x) {
    const int h = w / kWords, word = w % kWords;
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // elements 2 j, 2 j + 1 of the word: the inverse of kfrag / vfrag
      // within the chunk (a whole number of 8- or 16-key tiles)
      const int p = word * 4 + j;
      if (sel == 0) {
        const int reg = p % (D / 8), lane = (p / (D / 8)) % 32, st = p / (D / 8) / 32;
        const int s = 8 * st + (lane >> 2), d = 16 * (reg >> 1) + 8 * (reg & 1) + 2 * (lane & 3);
        out[j] = *reinterpret_cast<const uint32_t*>(tile + s * E + h * D + d);
      } else {
        const int reg = p % (D / 4), lane = (p / (D / 4)) % 32, st = p / (D / 4) / 32;
        const int s = 16 * st + 8 * (reg & 1) + 2 * (lane & 3), d = 8 * (reg >> 1) + (lane >> 2);
        out[j] = pack_pair(tile[s * E + h * D + d], tile[(s + 1) * E + h * D + d]);
      }
    }
    bf16* unit = a.kv + ((((size_t)b * a.L + a.l) * a.H + h) * 2 + sel) * a.Sp * D;
    reinterpret_cast<uint4*>(unit + (size_t)ch * 32 * D)[word] =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

}  // namespace sd

// ptrs: layer l's K and V (B, S, H, D), the packed K/V (B, L, H, 2, Sp D)
// ints: B, L, l, H, D, S, Sp
extern "C" int sd_pack_context_kv(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  PackArgs a;
  a.k = static_cast<const bf16*>(ptrs[0]);
  a.v = static_cast<const bf16*>(ptrs[1]);
  a.kv = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  const int B = ints[0], D = ints[4];
  a.L = ints[1];
  a.l = ints[2];
  a.H = ints[3];
  a.S = ints[5];
  a.Sp = ints[6];
  if ((D != 32 && D != 64 && D != kWideHead) || a.H * D > (D == kWideHead ? 512 : 256) ||
      a.Sp % 32 != 0 || a.Sp <= a.S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.Sp / 32, 2, B);
  if (D == 32) {
    pack_context_kv_kernel<32><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  } else if (D == 64) {
    pack_context_kv_kernel<64><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    pack_context_kv_kernel<128><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

// ptrs: the 19 PassArgs weight pointers (declaration order: emb_t .. fc_b),
//       noisy, packed K/V, stk, stv, out
// ints: L, E, H, P, J, Jp, B, S, Sp, has_coefs, threads per block (512, or
//       256: two blocks on an SM, or head_dim 128's block), blocks a robot (1
//       or 2);  floats: c0..c3
extern "C" int sd_fused_denoise(const void* const* ptrs, const int* ints, const float* floats,
                                void* stream) {
  using namespace sd;
  DenoiseArgs a;
  const bf16** w = &a.emb_t;
  for (int i = 0; i < kPassWeights; ++i) w[i] = static_cast<const bf16*>(ptrs[i]);
  a.noisy = static_cast<const float*>(ptrs[19]);
  a.kv = static_cast<bf16*>(const_cast<void*>(ptrs[20]));
  a.stk = static_cast<const bf16*>(ptrs[21]);
  a.stv = static_cast<const bf16*>(ptrs[22]);
  a.out = static_cast<float*>(const_cast<void*>(ptrs[23]));
  a.L = ints[0];
  a.E = ints[1];
  a.H = ints[2];
  a.P = ints[3];
  a.J = ints[4];
  a.Jp = ints[5];
  a.B = ints[6];
  a.S = ints[7];
  a.Sp = ints[8];
  a.has_coefs = ints[9];
  a.c0 = floats[0];
  a.c1 = floats[1];
  a.c2 = floats[2];
  a.c3 = floats[3];
  const int threads = ints[10], cs = ints[11], D = pass_head_dim(a.E, a.H);
  if (!pass_shape_ok(a, D, threads, cs)) return (int)cudaErrorInvalidValue;
  a.nbuf = kv_buffers(D, threads);
  void (*kernel)(DenoiseArgs);
  if (D == 32) {
    kernel = cs == 1 ? fused_denoise_kernel<32, 4, 1> : fused_denoise_kernel<32, 4, 2>;
  } else if (D == kWideHead) {
    kernel = cs == 1 ? fused_denoise_kernel<128, 16, 1> : fused_denoise_kernel<128, 16, 2>;
  } else if (a.E == 128) {
    kernel = cs == 1 ? fused_denoise_kernel<64, 4, 1> : fused_denoise_kernel<64, 4, 2>;
  } else {
    kernel = cs == 1 ? fused_denoise_kernel<64, 8, 1> : fused_denoise_kernel<64, 8, 2>;
  }
  const size_t smem = pass_smem_bytes(a.L, a.P, a.E, a.H, a.J, a.Jp, a.Sp, threads, cs, 0);
  return launch_robots(kernel, a, threads, cs, smem, stream);
}

// The shared memory of one decoder pass (decoder_pass.cuh:pass_smem_bytes),
// exported so that its Python mirror (ops/fused_denoise.py:pass_smem_bytes,
// which the wrappers' shape checks use) can be held equal to it.
// ints: L, P, E, H, J, Jp, Sp, threads per block, blocks a robot, carry floats
extern "C" long long sd_pass_smem_bytes(const int* ints) {
  return (long long)sd::pass_smem_bytes(ints[0], ints[1], ints[2], ints[3], ints[4], ints[5],
                                        ints[6], ints[7], ints[8], (size_t)ints[9]);
}
