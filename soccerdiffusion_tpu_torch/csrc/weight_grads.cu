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
// Bound on the H100: scalar fp32 FMAs from shared-memory tiles (4 x 4
// register blocking per thread); 2 K N R FLOP against (K + N) R bf16 reads.
#include <algorithm>

#include "train_common.cuh"

namespace sd {

constexpr int kTile = 64, kRows = 32, kMaxJobs = 16;

struct TdotArgs {
  TdotJob job[kMaxJobs];
  int rows_per_split;
};

struct SumArgs {
  SumJob job[kMaxJobs];
};

__global__ void __launch_bounds__(kThreads) tdot_kernel(TdotArgs args) {
  __shared__ __align__(16) float As[kRows][kTile];
  __shared__ __align__(16) float Bs[kRows][kTile];
  const TdotJob jb = args.job[blockIdx.z];
  const int tiles_n = (jb.N + kTile - 1) / kTile;
  const int tiles = tiles_n * ((jb.K + kTile - 1) / kTile);
  const int splits = tdot_splits(jb.R, args.rows_per_split);
  if ((int)blockIdx.x >= tiles || (int)blockIdx.y >= splits) return;
  const int k0 = (blockIdx.x / tiles_n) * kTile, n0 = (blockIdx.x % tiles_n) * kTile;
  const int r0 = blockIdx.y * args.rows_per_split;
  const int r1 = min(jb.R, r0 + args.rows_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 16 threads, 4 x 4 outputs each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r = r0; r < r1; r += kRows) {
    for (int e = threadIdx.x; e < kRows * kTile; e += blockDim.x) {
      const int rr = e / kTile, cc = e % kTile, row = r + rr;
      const bool live = row < r1;
      As[rr][cc] = (live && k0 + cc < jb.K) ? tof(jb.a[(size_t)row * jb.lda + k0 + cc]) : 0.f;
      Bs[rr][cc] = (live && n0 + cc < jb.N) ? tof(jb.b[(size_t)row * jb.ldb + n0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a4[i] * b4[j];
    }
    __syncthreads();
  }
  float* part = jb.part + (size_t)blockIdx.y * jb.K * jb.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < jb.K && n < jb.N) part[(size_t)k * jb.N + n] = acc[i][j];
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
