// Weight-gradient products of the training kernels, over every row of the
// batch: C[K, N] = sum_r A[r][:K]^T B[r][:N] with bf16 operands and fp32
// sums (the `tdot` contractions of soccerdiffusion_tpu/ops/
// fused_decoder_layer.py and fused_encoder_stack.py:_make_bwd_kernel,
// which accumulate across a sequential TPU grid).
//
// Thread blocks run concurrently on the H100, so the TPU kernels' `+=`
// into one output across grid steps is not carried over, and fp32
// atomics are not used (the sum would depend on the schedule). Instead:
//   1. tdot_kernel: one block per (64 x 64 output tile, chunk of
//      rows_per_split rows, job) writes its chunk's partial tile to an fp32
//      scratch;
//   2. sum_kernel: sums the chunks of every output element in chunk order
//      (and, as further jobs, the per-robot bias / LayerNorm partials).
// The result depends on the shapes only, not on the order blocks ran in.
//
// Bound on the H100: 2 K N R FLOP against (K + N) R bf16 reads -- at the
// ViT backward's N=640 frames (R = 40,960 rows, 0.79 M weights) 64 GFLOP
// and 0.16 GB: compute-bound, 0.065 ms at the bf16 tensor-core peak. The
// first port used scalar fp32 FMAs (4 x 4 register blocks); the products now
// run on the tensor cores: each block stages 32-row slabs of its A and B
// column tiles in shared memory (double-buffered, the next slab's 16-byte
// loads in flight during the current slab's products) and its 8 warps read
// them with ldmatrix.trans -- A^T as the mma's row-major A, B as its
// column-major B -- into mma.sync m16n8k16 bf16 products (16 x 32 outputs a
// warp). The partials and their ordered sum stay as they were, so the
// gradients are bit-identical from run to run. What bounds it now: the fp32
// partials (written and summed once per 1024-row chunk) and the 64 x 64
// tiles' shared-memory traffic.
#include <algorithm>

#include "mma.cuh"

namespace sd {

constexpr int kTile = 64, kRows = 32, kMaxJobs = 16;
constexpr int kLds = kTile + 8;  // staged row stride (bf16): 144 B, conflict-free ldmatrix rows

struct TdotArgs {
  TdotJob job[kMaxJobs];
  int rows_per_split;
};

struct SumArgs {
  SumJob job[kMaxJobs];
};

// One (64 x 64 output tile, chunk of rows, job) per block; 8 warps of 16 x
// 32 outputs. Rows past the chunk and columns past K / N stage as zeros.
__global__ void __launch_bounds__(kThreads) tdot_kernel(TdotArgs args) {
  __shared__ __align__(16) bf16 As[2][kRows][kLds];
  __shared__ __align__(16) bf16 Bs[2][kRows][kLds];
  const TdotJob jb = args.job[blockIdx.z];
  const int tiles_n = (jb.N + kTile - 1) / kTile;
  const int tiles = tiles_n * ((jb.K + kTile - 1) / kTile);
  const int splits = tdot_splits(jb.R, args.rows_per_split);
  if ((int)blockIdx.x >= tiles || (int)blockIdx.y >= splits) return;
  const int k0 = (blockIdx.x / tiles_n) * kTile, n0 = (blockIdx.x % tiles_n) * kTile;
  const int r0 = blockIdx.y * args.rows_per_split;
  const int r1 = min(jb.R, r0 + args.rows_per_split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2, mi = lane >> 3, mr = lane & 7;
  // each thread stages one 16-byte chunk of A and of B per slab
  const int sr = threadIdx.x >> 3, sc = (threadIdx.x & 7) * 8;
  const bool a_in = k0 + sc < jb.K, b_in = n0 + sc < jb.N;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int r, uint4& va, uint4& vb) {
    const int row = r + sr;
    va = row < r1 && a_in ? *reinterpret_cast<const uint4*>(jb.a + (size_t)row * jb.lda + k0 + sc)
                          : zero;
    vb = row < r1 && b_in ? *reinterpret_cast<const uint4*>(jb.b + (size_t)row * jb.ldb + n0 + sc)
                          : zero;
  };
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint4 va, vb;
  fetch(r0, va, vb);
  int buf = 0;
  for (int r = r0; r < r1; r += kRows) {
    *reinterpret_cast<uint4*>(&As[buf][sr][sc]) = va;
    *reinterpret_cast<uint4*>(&Bs[buf][sr][sc]) = vb;
    __syncthreads();
    if (r + kRows < r1) fetch(r + kRows, va, vb);
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 16) {
      // A^T tile: output rows (K) wm*16.., reduction rows kk..; matrix i at
      // (row +8 (i & 1), reduction +8 (i >> 1))
      uint32_t a[4], b[4][2];
      ldsm_x4_trans(a, &As[buf][kk + 8 * (mi >> 1) + mr][wm * 16 + 8 * (mi & 1)]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        // B tiles 2 nb, 2 nb + 1: matrix i at (reduction +8 (i & 1), column +8 (i >> 1))
        uint32_t t[4];
        ldsm_x4_trans(t, &Bs[buf][kk + 8 * (mi & 1) + mr][wn * 32 + 16 * nb + 8 * (mi >> 1)]);
        b[2 * nb][0] = t[0];
        b[2 * nb][1] = t[1];
        b[2 * nb + 1][0] = t[2];
        b[2 * nb + 1][1] = t[3];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, b[j]);
    }
    buf ^= 1;
  }
  float* part = jb.part + (size_t)blockIdx.y * jb.K * jb.N;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn * 32 + 8 * j + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wm * 16 + g + 8 * h;
      if (k < jb.K && n < jb.N)
        *reinterpret_cast<float2*>(part + (size_t)k * jb.N + n) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) sum_kernel(SumArgs args) {
  const SumJob jb = args.job[blockIdx.y];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < jb.len; e += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < jb.n; ++i) acc += jb.part[(size_t)i * jb.len + e];
    jb.out[e] = acc;
  }
}

static int launch_sums(const SumJob* jobs, int n, cudaStream_t stream) {
  for (int base = 0; base < n; base += kMaxJobs) {
    SumArgs a = {};
    const int count = std::min(kMaxJobs, n - base);
    int len = 0;
    for (int j = 0; j < count; ++j) {
      a.job[j] = jobs[base + j];
      len = std::max(len, jobs[base + j].len);
    }
    const int blocks = std::min(256, (len + kThreads - 1) / kThreads);
    sum_kernel<<<dim3(blocks, count), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch_weight_grads(const TdotJob* jobs, int n_jobs, const SumJob* extra, int n_extra,
                        int rows_per_split, cudaStream_t stream) {
  SumJob sums[2 * kMaxJobs];
  if (n_jobs + n_extra > 2 * kMaxJobs || rows_per_split % kRows != 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte staging loads: 8-element row strides, widths and bases
  for (int j = 0; j < n_jobs; ++j) {
    const TdotJob& jb = jobs[j];
    if (jb.lda % 8 || jb.ldb % 8 || jb.K % 8 || jb.N % 8 ||
        reinterpret_cast<uintptr_t>(jb.a) % 16 || reinterpret_cast<uintptr_t>(jb.b) % 16)
      return (int)cudaErrorInvalidValue;
  }
  for (int base = 0; base < n_jobs; base += kMaxJobs) {
    TdotArgs a = {};
    a.rows_per_split = rows_per_split;
    const int count = std::min(kMaxJobs, n_jobs - base);
    int tiles = 0, splits = 0;
    for (int j = 0; j < count; ++j) {
      const TdotJob& jb = jobs[base + j];
      a.job[j] = jb;
      tiles = std::max(tiles, ((jb.N + kTile - 1) / kTile) * ((jb.K + kTile - 1) / kTile));
      splits = std::max(splits, tdot_splits(jb.R, rows_per_split));
    }
    tdot_kernel<<<dim3(tiles, splits, count), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int j = 0; j < n_jobs; ++j)
    sums[j] = SumJob{jobs[j].part, jobs[j].out, tdot_splits(jobs[j].R, rows_per_split),
                     jobs[j].K * jobs[j].N};
  for (int j = 0; j < n_extra; ++j) sums[n_jobs + j] = extra[j];
  return launch_sums(sums, n_jobs + n_extra, stream);
}

}  // namespace sd
