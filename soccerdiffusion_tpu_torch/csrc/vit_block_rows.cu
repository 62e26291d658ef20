// The fused ViT block's backward over row tiles of all N frames (the
// row-tiled path of ops/fused_vit_block.py:backward_kernel): warpgroup
// products (wgmma) over 128-row tiles fed by TMA, with the LayerNorm, GELU
// and bias work in the products' epilogues.
//
// Replaces soccerdiffusion_tpu/ops/fused_vit_block.py:722 (_bwd_impl, the
// backward of make_vit_block_fn's custom_vjp), as vit_block.cuh's
// vit_block_bwd_kernel does for the shapes this path does not take: the
// same function at the same rounding points. x is the only residual, so the
// forward's internals are recomputed: bf16 n1 = LN1(x), q|k|v, the head
// outputs, n2 = LN2(x2) and hg = GELU(z); dq / dk / dv and dom rounded to
// bf16, dhg and dz in fp32 (dzc its bf16 copy), fp32 LayerNorm backwards,
// dx rounded once.
//
// Bound on the H100 at T=64, W=256, FF=1024: ~315 MFLOP a frame (the
// recompute, the input gradients and the four weight-gradient products, 3x
// the forward's FLOPs), 806 GFLOP at the flagship step's N=2560 frames:
// compute-bound at the bf16 tensor-core peak, 0.815 ms (0.204 ms at N=640).
// What bounded the per-frame kernel (vit_block_bwd_kernel<64, 1>: 4.559 ms
// at N=640, 22x its bound, PERF.md): one 8-warp block per frame and SM
// (255 registers a thread), each frame's 64-row products on mma.sync with
// every weight fragment read from L2 once a frame, ~1 MB of per-frame
// workspace through L2, and scalar LayerNorm and column-sum passes.
//
// Design: the backward is a chain of kernels over the N T rows, each
// product over 128-row tiles with every weight tile read once per row tile:
//   1. vit_rows_ln_kernel: n1 = bf16(LN1(x)), one warp a row;
//   2. q|k|v = bf16(n1 wqkv + bqkv);
//   3. vit_rows_attn_fwd_kernel: the head outputs om, one block a (frame,
//      head) over the head's q|k|v columns staged in shared memory;
//   4. x2 = x + om wo + bo (kept in fp32) and n2 = bf16(LN2(x2)) in the
//      epilogue: at W = 256 a tile spans whole rows, so the row statistics
//      are quad shuffles of the accumulator;
//   5. two products into one tile of 128 FF columns, z - b1 = n2 w1 and dhg
//      = dy w2^T, with the GELU and its gradient in the epilogue: hg, dzc
//      (bf16) and db1's tile partial; z never leaves the registers;
//   6. dn2 = dzc w1^T and the LN2 backward in the epilogue: dx2 (fp32), da
//      = bf16(dx2), and the bo / g2 / be2 / b2 tile partials;
//   7. dom = bf16(da wo^T);
//   8. vit_rows_attn_bwd_kernel: dq | dk | dv, one block a (frame, head)
//      over the head's q|k|v and dom columns staged in shared memory, the
//      scores in registers (mma.cuh's attention tiles), and bqkv's frame
//      partial;
//   9. dn1 = dqkv wqkv^T and the LN1 backward in the epilogue: dx =
//      bf16(dx2 + LN1'(dn1)), and the g1 / be1 tile partials;
//  10. vit_rows_wgrad_kernel: the four weight-gradient products over a few
//      splits of the rows, both operands read MN-major as they lie; then
//      weight_grads.cu's sum_kernel adds the splits and every tile or frame
//      partial in a fixed order (no atomics: bit-identical from run to run).
// The products of 2-9 (vit_rows_gemm_kernel) are persistent warp-specialised
// blocks: a producer warpgroup keeps a ring of 4 (6 at 128 columns) stages
// filled by TMA (a 128 x 64 A tile and a BN x 64 weight tile, the 128-byte
// swizzle) on mbarriers, while two consumer warpgroups each run m64nBNk16
// wgmma over 64 of the tile's rows, one stage's group in flight while the
// next issues, and then the epilogue, which overlaps the next tile's loads.
// Several kernels, not one: each product needs every row of the previous
// one's output for its rows (the LN epilogues need whole rows, attention
// whole frames), and a kernel boundary is the cheapest grid-wide barrier;
// the operands between them (bf16 but for x2 and dx2) stream through HBM at
// ~2 GB a launch at N=2560. The tiles need not hold whole frames: only the
// attention kernels work per frame. Rows past N T arrive as zeros and are
// neither stored nor summed.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, PERF.md §6): about 5.4 ms
// at N=2560, 6.7x its bound, against 14.8 for the per-frame kernel. The
// products run at 130-215 TFLOP/s: the GELU product 1.04-1.12 ms, the LN2
// and LN1 backward products 0.65 and 0.49, q|k|v and dom together 0.44, the
// residual-LN product 0.23; the weight-gradient products 0.65 ms, the
// attention backward 0.67 and forward 0.27, the ordered sums 0.16. Keeping
// a stage's wgmma group in flight did not move the products, nor (within
// 3-5%) did keeping the weights resident in shared memory: each tile's
// epilogue runs after its own products on the same two warpgroups, which
// is the next thing to take apart (one warpgroup's epilogue beside the
// other's products).
#include <algorithm>

#include "encoder_layer.cuh"
#include "wgmma.cuh"

namespace sd {

constexpr int kRowTile = 128;       // rows of a product tile: two consumer warpgroups of 64
constexpr int kKTile = 64;          // reduction columns of a stage: 128 bytes of bf16
constexpr int kRowsThreads = 384;   // a producer warpgroup and two consumers
constexpr int kRowsWidth = 256;     // W: a 256-column tile spans a row (the LN epilogues)
constexpr int kRingBytes = 192 * 1024;

template <int BN>
struct RowShape {
  static constexpr int kABytes = kRowTile * kKTile * 2;  // a 128 x 64 A tile: 16 KB
  static constexpr int kStage = kABytes + BN * kKTile * 2;
  static constexpr int kStages = kRingBytes / kStage;  // 4 at BN 256, 6 at 128
  static constexpr int kRedBytes = 8 * 256 * 4;        // tile_colsum: 8 warps x 256 columns
  // 1024 bytes of slack to align the ring, the ring, the reduction, the barriers
  static constexpr int kSmem = 1024 + kStages * kStage + kRedBytes + 2 * kStages * 8;
};

struct RowMaps {  // the A (rows) and B (weight, (out, in)) tensor maps of each segment
  CUtensorMap a[2], b[2];
};

__device__ __forceinline__ void consumer_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// out[col] for col < 8 NJ: the sum over the tile's rows of each column, v[j][e]
// holding this thread's own rows' sum of column 8 j + 2 c + e. The 8 lanes of
// equal c are summed by shuffles, the 8 consumer warps through red in warp
// order: the same order every run. Every consumer thread calls it.
template <int NJ>
__device__ void tile_colsum(const float (&v)[NJ][2], int cw, int tid, float* red, float* out) {
  const int lane = tid & 31, w = cw * 4 + (tid >> 5), c = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = v[j][e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) red[w * 256 + 8 * j + 2 * c + e] = x;
    }
  consumer_sync();
  const int col = cw * 128 + tid;
  if (col < 8 * NJ) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += red[i * 256 + col];
    out[col] = s;
  }
  consumer_sync();
}

// this thread's first accumulator row in tile m (the second is 8 on)
__device__ __forceinline__ int frag_row(int m, int cw, int tid) {
  return m * kRowTile + cw * 64 + (tid >> 5) * 16 + ((tid & 31) >> 2);
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ the products
// Y (R, col_tiles BN) = sum over segments s of A_s (R, 64 nk_s) . B_s^T, B_s
// stored (BN col_tiles, 64 nk_s): a weight in (out, in) order; segment s sums
// into acc[s]. epi(acc, R, m, n, cw, tid, red) takes tile (m, n) from the
// consumers' registers.
template <int BN, int NSEG, class Epi>
__global__ void __launch_bounds__(kRowsThreads, 1)
    vit_rows_gemm_kernel(const __grid_constant__ RowMaps maps, const Epi epi, int R,
                         int col_tiles, int nk0, int nk1) {
  using S = RowShape<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + S::kStages * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 256);
  uint64_t* empty = full + S::kStages;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int tiles = ((R + kRowTile - 1) / kRowTile) * col_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {  // producer: one thread issues the copies
    regs_dealloc<40>();
    if (tid == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m = t / col_tiles, n = t % col_tiles;
        for (int seg = 0; seg < NSEG; ++seg) {
          const int nk = seg == 0 ? nk0 : nk1;
          for (int kb = 0; kb < nk; ++kb, ++it) {
            const int s = it % S::kStages;
            mbar_wait(&empty[s], ((it / S::kStages) & 1) ^ 1);
            uint8_t* st = ring + s * S::kStage;
            mbar_arrive_expect_tx(&full[s], S::kStage);
            tma_load_2d(st, &maps.a[seg], &full[s], kb * kKTile, m * kRowTile);
            tma_load_2d(st + S::kABytes, &maps.b[seg], &full[s], kb * kKTile, n * BN);
          }
        }
      }
    }
  } else {  // consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile
    regs_alloc<232>();
    const int cw = wg - 1;
    float acc[NSEG][BN / 2];
#pragma unroll
    for (int seg = 0; seg < NSEG; ++seg)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[seg][i] = 0.f;
    // one stage's products stay in flight while the next stage's issue: a
    // stage is released once the group after it has been committed and the
    // wait leaves only that one outstanding
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m = t / col_tiles, n = t % col_tiles;
      int prev = -1;
#pragma unroll
      for (int seg = 0; seg < NSEG; ++seg) {
        const int nk = seg == 0 ? nk0 : nk1;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S::kStages;
          mbar_wait(&full[s], (it / S::kStages) & 1);
          const uint8_t* st = ring + s * S::kStage;
          const uint64_t da = sw128_desc(st + cw * 64 * 128), db = sw128_desc(st + S::kABytes);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < kKTile / 16; ++k)
            wgmma_bf16<BN>(acc[seg], da + 2 * k, db + 2 * k, (kb > 0 || k > 0) ? 1 : 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int seg = 0; seg < NSEG; ++seg) fence_regs<BN / 2>(acc[seg]);
      if (tid == 0) mbar_arrive(&empty[prev]);
      epi(acc, R, m, n, cw, tid, red);
    }
  }
}

// ------------------------------------------------------------- epilogues
// out[r][256 n + col] = bf16(acc + bias) (bias may be null): q|k|v, dom
struct EpiBiasBf16 {
  bf16* out;
  const bf16* bias;
  int ld;
  __device__ void operator()(float (&acc)[1][128], int R, int m, int n, int cw, int tid,
                             float*) const {
    const int r0 = frag_row(m, cw, tid), c = tid & 3;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n * 256 + 8 * j + 2 * c;
      const float b0 = bias != nullptr ? tof(bias[col]) : 0.f;
      const float b1 = bias != nullptr ? tof(bias[col + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < R)
          st_bf2(out + (size_t)r * ld + col, acc[0][4 * j + 2 * h] + b0,
                 acc[0][4 * j + 2 * h + 1] + b1);
      }
    }
  }
};

// x2 = x + (acc + bo) in fp32, n2 = bf16(LN2(x2) g + b)
struct EpiResidualLn {
  const bf16 *x, *bo, *g, *b;
  float* x2;
  bf16* n2;
  __device__ void operator()(float (&acc)[1][128], int R, int m, int, int cw, int tid,
                             float*) const {
    constexpr int W = kRowsWidth;
    const int r0 = frag_row(m, cw, tid), c = tid & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const bool in = r < R;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * c;
        const float2 xv = in ? ld_bf2(x + (size_t)r * W + col) : make_float2(0.f, 0.f);
        float& v0 = acc[0][4 * j + 2 * h];
        float& v1 = acc[0][4 * j + 2 * h + 1];
        v0 = xv.x + (v0 + tof(bo[col]));
        v1 = xv.y + (v1 + tof(bo[col + 1]));
        s += v0 + v1;
      }
      const float mean = quad_sum(s) / W;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d0 = acc[0][4 * j + 2 * h] - mean, d1 = acc[0][4 * j + 2 * h + 1] - mean;
        q += d0 * d0 + d1 * d1;
      }
      const float rstd = rsqrtf(quad_sum(q) / W + kLnEps);
      if (!in) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * j + 2 * c;
        const float v0 = acc[0][4 * j + 2 * h], v1 = acc[0][4 * j + 2 * h + 1];
        *reinterpret_cast<float2*>(x2 + (size_t)r * W + col) = make_float2(v0, v1);
        st_bf2(n2 + (size_t)r * W + col, (v0 - mean) * rstd * tof(g[col]) + tof(b[col]),
               (v1 - mean) * rstd * tof(g[col + 1]) + tof(b[col + 1]));
      }
    }
  }
};

// acc[0] = z - b1 (n2 w1), acc[1] = dhg (dy w2^T) over FF columns 128 n ..:
// hg = bf16(GELU(z)), dz = dhg GELU'(z), dzc = bf16(dz), db1's tile partial
template <int G>
struct EpiGelu {
  const bf16* b1;
  bf16 *hg, *dzc;
  float* part;  // (tiles, FF)
  int FF;
  __device__ void operator()(float (&acc)[2][64], int R, int m, int n, int cw, int tid,
                             float* red) const {
    const int r0 = frag_row(m, cw, tid), c = tid & 3;
    float cs[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n * 128 + 8 * j + 2 * c;
      const float bb0 = tof(b1[col]), bb1 = tof(b1[col + 1]);
      cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= R) continue;
        const float z0 = acc[0][4 * j + 2 * h] + bb0, z1 = acc[0][4 * j + 2 * h + 1] + bb1;
        const float d0 = gelu_dz<G>(acc[1][4 * j + 2 * h], z0);
        const float d1 = gelu_dz<G>(acc[1][4 * j + 2 * h + 1], z1);
        st_bf2(hg + (size_t)r * FF + col, gelu_value<G>(z0), gelu_value<G>(z1));
        st_bf2(dzc + (size_t)r * FF + col, d0, d1);
        cs[j][0] += d0;
        cs[j][1] += d1;
      }
    }
    tile_colsum<16>(cs, cw, tid, red, part + (size_t)m * FF + n * 128);
  }
};

// the fp32 mean and 1 / std of row r's W values at columns 8 j + 2 c (+1)
// of this thread (a quad holds the row), read by ld2
template <class Ld2>
__device__ __forceinline__ void row_stats(Ld2 ld2, bool in, int c, float& mean, float& rstd) {
  constexpr int W = kRowsWidth;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 v = in ? ld2(8 * j + 2 * c) : make_float2(0.f, 0.f);
    s += v.x + v.y;
  }
  mean = quad_sum(s) / W;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 v = in ? ld2(8 * j + 2 * c) : make_float2(0.f, 0.f);
    q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
  rstd = rsqrtf(quad_sum(q) / W + kLnEps);
}

// The LayerNorm backward of a whole-row tile, acc = dn (the gradient of the
// LN output): with xhat from the LN input (ld2(r, col)) and the scale g,
//   out = base + rstd (dn g - mean(dn g) - xhat mean(dn g xhat))
// handed to store(r, col, out0, out1), base(r, col) a pair of fp32; rows
// past R are neither read nor stored. The tile partials of g and beta (the
// column sums of dn xhat and of dn) go to gpart / bpart, and with opart
// those of out.
template <class Ld2, class Base, class Store>
__device__ __forceinline__ void ln_bwd_tile(float (&acc)[1][128], int R, int r0, int cw, int tid,
                                            float* red, Ld2 ld2, const bf16* g, Base base,
                                            Store store, float* gpart, float* bpart,
                                            float* opart) {
  constexpr int W = kRowsWidth;
  const int c = tid & 3;
  float mean[2], rstd[2], m1[2], m2[2];
  float cs[32][2];
#pragma unroll
  for (int j = 0; j < 32; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool in = r < R;
    auto row = [&](int col) { return ld2(r, col); };
    row_stats(row, in, c, mean[h], rstd[h]);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * c;
      if (!in) continue;
      const float2 v = row(col);
      const float xh0 = (v.x - mean[h]) * rstd[h], xh1 = (v.y - mean[h]) * rstd[h];
      const float dn0 = acc[0][4 * j + 2 * h], dn1 = acc[0][4 * j + 2 * h + 1];
      const float d0 = dn0 * tof(g[col]), d1 = dn1 * tof(g[col + 1]);
      s1 += d0 + d1;
      s2 += d0 * xh0 + d1 * xh1;
      cs[j][0] += dn0 * xh0;
      cs[j][1] += dn1 * xh1;
    }
    m1[h] = quad_sum(s1) / W;
    m2[h] = quad_sum(s2) / W;
  }
  tile_colsum<32>(cs, cw, tid, red, gpart);
#pragma unroll
  for (int j = 0; j < 32; ++j)  // rows past R hold zeros (their A rows arrived as zeros)
#pragma unroll
    for (int e = 0; e < 2; ++e) cs[j][e] = acc[0][4 * j + e] + acc[0][4 * j + 2 + e];
  tile_colsum<32>(cs, cw, tid, red, bpart);
#pragma unroll
  for (int j = 0; j < 32; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 8 * j + 2 * c;
      const float2 v = ld2(r, col);
      const float xh0 = (v.x - mean[h]) * rstd[h], xh1 = (v.y - mean[h]) * rstd[h];
      const float d0 = acc[0][4 * j + 2 * h] * tof(g[col]);
      const float d1 = acc[0][4 * j + 2 * h + 1] * tof(g[col + 1]);
      const float2 b = base(r, col);
      const float o0 = b.x + rstd[h] * (d0 - m1[h] - xh0 * m2[h]);
      const float o1 = b.y + rstd[h] * (d1 - m1[h] - xh1 * m2[h]);
      store(r, col, o0, o1);
      cs[j][0] += o0;
      cs[j][1] += o1;
    }
  }
  if (opart != nullptr) tile_colsum<32>(cs, cw, tid, red, opart);
}

// acc = dn2 (dzc w1^T): dx2 = dy + LN2'(dn2) in fp32 and da = bf16(dx2); the
// tile partials [bo | g2 | be2] (tiles, 3W) and b2 (tiles, W)
struct EpiLn2Bwd {
  const float* x2;
  const bf16 *dy, *g;
  float* dx2;
  bf16* da;
  float *p3, *pb2;
  __device__ void operator()(float (&acc)[1][128], int R, int m, int, int cw, int tid,
                             float* red) const {
    constexpr int W = kRowsWidth;
    const int r0 = frag_row(m, cw, tid), c = tid & 3;
    const float* x2p = x2;
    const bf16* dyp = dy;
    float* dx2p = dx2;
    bf16* dap = da;
    auto ld2 = [x2p](int r, int col) {
      return *reinterpret_cast<const float2*>(x2p + (size_t)r * kRowsWidth + col);
    };
    auto base = [dyp](int r, int col) { return ld_bf2(dyp + (size_t)r * kRowsWidth + col); };
    auto store = [dx2p, dap](int r, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(dx2p + (size_t)r * kRowsWidth + col) = make_float2(v0, v1);
      st_bf2(dap + (size_t)r * kRowsWidth + col, v0, v1);
    };
    float* p = p3 + (size_t)m * 3 * W;
    ln_bwd_tile(acc, R, r0, cw, tid, red, ld2, g, base, store, p + W, p + 2 * W, p);
    float cs[32][2];  // b2: the column sums of dy
#pragma unroll
    for (int j = 0; j < 32; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 v = ld_bf2(dy + (size_t)r * W + 8 * j + 2 * c);
        cs[j][0] += v.x;
        cs[j][1] += v.y;
      }
    }
    tile_colsum<32>(cs, cw, tid, red, pb2 + (size_t)m * W);
  }
};

// acc = dn1 (dqkv wqkv^T): dx = bf16(dx2 + LN1'(dn1)); the tile partials
// [g1 | be1] (tiles, 2W)
struct EpiLn1Bwd {
  const bf16 *x, *g;
  const float* dx2;
  bf16* dx;
  float* p2;
  __device__ void operator()(float (&acc)[1][128], int R, int m, int, int cw, int tid,
                             float* red) const {
    constexpr int W = kRowsWidth;
    const bf16* xp = x;
    const float* bp = dx2;
    bf16* dxp = dx;
    auto ld2 = [xp](int r, int col) { return ld_bf2(xp + (size_t)r * kRowsWidth + col); };
    auto base = [bp](int r, int col) {
      return *reinterpret_cast<const float2*>(bp + (size_t)r * kRowsWidth + col);
    };
    auto store = [dxp](int r, int col, float v0, float v1) {
      st_bf2(dxp + (size_t)r * kRowsWidth + col, v0, v1);
    };
    float* p = p2 + (size_t)m * 2 * W;
    ln_bwd_tile(acc, R, frag_row(m, cw, tid), cw, tid, red, ld2, g, base, store, p, p + W,
                nullptr);
  }
};

// ------------------------------------------------- weight-gradient products
// C (K, N) = sum over the rows r of A[r][:K]^T B[r][:N], the block's four
// weight gradients (n1^T dqkv, om^T da, n2^T dzc, hg^T dy), on warpgroup
// products too: a block takes one 128 x 256 output tile over one split of
// the rows, in stages of 64 rows whose A (128 columns) and B (256 columns)
// boxes TMA copies as they lie -- both MN-major operands, the rows being the
// products' reduction axis -- and writes the tile's fp32 sum to part
// (splits, K, N); sum_kernel adds the splits in order (no atomics). The
// splits are few (wgrad_splits), so that the blocks fill the card once and
// the partials stay small.
constexpr int kWgK = 128, kWgN = 256, kWgRows = 64;
constexpr int kWgABytes = kWgRows * kWgK * 2;             // two 64-column boxes
constexpr int kWgStage = kWgABytes + kWgRows * kWgN * 2;  // and four: 48 KB
constexpr int kWgStages = 4;
constexpr int kWgSmem = 1024 + kWgStages * kWgStage + 2 * kWgStages * 8;

struct WgradArgs {
  CUtensorMap a[4], b[4];  // product j's A (R, K) and B (R, N), boxes of 64 rows x 64 columns
  float* part[4];          // (splits, K, N)
  int K[4], N[4];
  int first[5];  // product j's blocks are first[j] .. first[j + 1] - 1
  int R, rows_per_split, splits;
};

__global__ void __launch_bounds__(kRowsThreads, 1)
    vit_rows_wgrad_kernel(const __grid_constant__ WgradArgs args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStage);
  uint64_t* empty = full + kWgStages;
  int j = 0;
  while (j < 3 && (int)blockIdx.x >= args.first[j + 1]) ++j;
  const int local = blockIdx.x - args.first[j], K = args.K[j], N = args.N[j];
  const int split = local % args.splits, tile = local / args.splits, tiles_n = N / kWgN;
  const int k0 = (tile / tiles_n) * kWgK, n0 = (tile % tiles_n) * kWgN;
  const int r0 = split * args.rows_per_split, r1 = min(args.R, r0 + args.rows_per_split);
  const int nst = (r1 - r0 + kWgRows - 1) / kWgRows;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {  // producer
    regs_dealloc<40>();
    if (tid == 0) {
      for (int i = 0; i < nst; ++i) {
        const int s = i % kWgStages, r = r0 + i * kWgRows;
        mbar_wait(&empty[s], ((i / kWgStages) & 1) ^ 1);
        uint8_t* st = ring + s * kWgStage;
        mbar_arrive_expect_tx(&full[s], kWgStage);
        for (int q = 0; q < 2; ++q)
          tma_load_2d(st + q * 8192, &args.a[j], &full[s], k0 + 64 * q, r);
        for (int q = 0; q < 4; ++q)
          tma_load_2d(st + kWgABytes + q * 8192, &args.b[j], &full[s], n0 + 64 * q, r);
      }
    }
  } else {  // consumers: warpgroup cw takes output rows k0 + 64 cw .. + 63
    regs_alloc<232>();
    const int cw = wg - 1;
    float acc[4][32];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
    int prev = -1;
    for (int i = 0; i < nst; ++i) {
      const int s = i % kWgStages;
      mbar_wait(&full[s], (i / kWgStages) & 1);
      const uint8_t* st = ring + s * kWgStage;
      const uint64_t da = sw128_mn_desc(st + cw * 8192), db = sw128_mn_desc(st + kWgABytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWgRows / 16; ++k)  // 16 rows (2048 bytes) a step
#pragma unroll
        for (int q = 0; q < 4; ++q)  // 64 columns of B (8192 bytes) a box
          wgmma_m64n64k16_mn(acc[q], da + 128 * k, db + 512 * q + 128 * k,
                             (i > 0 || k > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_regs<32>(acc[q]);
    float* out = args.part[j] + (size_t)split * K * N;
    const int lane = tid & 31, c = lane & 3;
    const int k = k0 + cw * 64 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + (size_t)(k + 8 * h) * N + n0 + 64 * q + 8 * jj + 2 * c) =
              make_float2(acc[q][4 * jj + 2 * h], acc[q][4 * jj + 2 * h + 1]);
  }
}

// ------------------------------------------------------ row and frame kernels
// out = bf16(LN(x) g + b), one warp a row (encoder_layer.cuh:ln_rows' sums)
__global__ void __launch_bounds__(kThreads)
    vit_rows_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       const bf16* __restrict__ b, bf16* __restrict__ out, int R, int W) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const bf16* xr = x + (size_t)r * W;
  float s = 0.f;
  for (int e = lane; e < W; e += 32) s += tof(xr[e]);
  const float mean = warp_sum(s) / W;
  float v = 0.f;
  for (int e = lane; e < W; e += 32) {
    const float d = tof(xr[e]) - mean;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / W + kLnEps);
  for (int e = lane; e < W; e += 32)
    out[(size_t)r * W + e] = __float2bfloat16((tof(xr[e]) - mean) * rs * tof(g[e]) + tof(b[e]));
}

// Attention, one head of one frame a block of 4 warps (16 query or key rows
// a warp item, mma.cuh's tiles, the scores in registers): the head's q | k |
// v columns (T, 3D + 8), and for the backward its dom columns (T, D + 8) and
// the softmax statistics (3 T floats), staged in shared memory, rows padded
// by 8 so that the 8 rows of an ldmatrix hit 8 bank quads. Small blocks, so
// that 4 share an SM: one block a frame (8 warps at up to 255 registers a
// thread) left each SM 8 warps to hide the tiles' latency with.
constexpr int kHeadThreads = 128;

__host__ __device__ inline size_t head_attn_smem(bool bwd, int T, int D) {
  const size_t q = 2 * (size_t)T * (3 * D + 8);
  return bwd ? q + 2 * (size_t)T * (D + 8) + 12 * (size_t)T : q;
}

template <int D>
__device__ __forceinline__ void stage_head(const bf16* qkv, const bf16* dom, int T, int W, int o,
                                           bf16* sq, bf16* sd) {
  constexpr int C = D / 8;  // 16-byte chunks of a head's row
  for (int i = threadIdx.x; i < T * 3 * C; i += blockDim.x) {
    const int r = i / (3 * C), part = (i % (3 * C)) / C, c8 = (i % C) * 8;
    *reinterpret_cast<uint4*>(sq + (size_t)r * (3 * D + 8) + part * D + c8) =
        *reinterpret_cast<const uint4*>(qkv + (size_t)r * 3 * W + part * W + o + c8);
  }
  if (dom == nullptr) return;
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    const int r = i / C, c8 = (i % C) * 8;
    *reinterpret_cast<uint4*>(sd + (size_t)r * (D + 8) + c8) =
        *reinterpret_cast<const uint4*>(dom + (size_t)r * W + o + c8);
  }
}

// the head outputs om from the frame's q|k|v rows
template <int D>
__global__ void __launch_bounds__(kHeadThreads, 4)
    vit_rows_attn_fwd_kernel(const bf16* qkv, bf16* om, int T, int W, int H) {
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);
  const int f = blockIdx.x / H, o = (blockIdx.x % H) * D, ldq = 3 * D + 8;
  stage_head<D>(qkv + (size_t)f * T * 3 * W, nullptr, T, W, o, sq, nullptr);
  __syncthreads();
  for (int m = threadIdx.x >> 5; m < (T + 15) / 16; m += blockDim.x >> 5)
    attn_fwd_tile<D, true>(sq, ldq, T, sq + D, sq + 2 * D, ldq, T, 16 * m,
                           om + (size_t)f * T * W + o, W);
}

// dq | dk | dv from the frame's q|k|v and dom rows (a pass over 16-query
// items, then one over 16-key items), and their column sums over the frame
// (bqkv's frame partial)
template <int D>
__global__ void __launch_bounds__(kHeadThreads, 4)
    vit_rows_attn_bwd_kernel(const bf16* qkv, const bf16* dom, bf16* dqkv, float* part, int T,
                             int W, int H) {
  extern __shared__ float4 smem4[];
  const int f = blockIdx.x / H, o = (blockIdx.x % H) * D, ldq = 3 * D + 8, ldd = D + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem4);
  bf16* sd = sq + (size_t)T * ldq;
  float* stats = reinterpret_cast<float*>(sd + (size_t)T * ldd);
  stage_head<D>(qkv + (size_t)f * T * 3 * W, dom + (size_t)f * T * W, T, W, o, sq, sd);
  __syncthreads();
  bf16* dq = dqkv + (size_t)f * T * 3 * W + o;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, tiles = (T + 15) / 16;
  for (int m = warp; m < tiles; m += nwarps)
    attn_bwd_dq_tile<D, true>(sq, ldq, T, sq + D, sq + 2 * D, ldq, T, sd, ldd, 16 * m, dq, 3 * W,
                              stats);
  __syncthreads();
  for (int m = warp; m < tiles; m += nwarps)
    attn_bwd_dkv_tile<D, false, true>(sq, ldq, T, sq + D, sq + 2 * D, ldq, T, sd, ldd, 16 * m,
                                      stats, dq + W, 3 * W, dq + 2 * W, 3 * W);
  __syncthreads();
  // bqkv's frame partial: this head's columns of dq, dk, dv summed over the rows in order
  float* p = part + (size_t)f * 3 * W + o;
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    const bf16* col = dq + (c / D) * W + c % D;
    float acc = 0.f;
    for (int r = 0; r < T; ++r) acc += tof(col[(size_t)r * 3 * W]);
    p[(c / D) * W + c % D] = acc;
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to it)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const char* name = "cuTensorMapEncodeTiled";
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix, read in boxes of box_rows x 64
static bool tile_map(CUtensorMap* map, const bf16* p, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kKTile, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Y (R, BN col_tiles) from A (R, K_s) x B_s (BN col_tiles, K_s), s < NSEG;
// persistent: at most one block an SM
template <int BN, int NSEG, class Epi>
static cudaError_t launch_rows_gemm(const bf16* const* a, const bf16* const* b, const int* k,
                                    int R, int col_tiles, const Epi& epi, cudaStream_t st) {
  using S = RowShape<BN>;
  RowMaps maps;
  for (int s = 0; s < NSEG; ++s) {
    if (!tile_map(&maps.a[s], a[s], R, k[s], kRowTile) ||
        !tile_map(&maps.b[s], b[s], BN * col_tiles, k[s], BN))
      return cudaErrorInvalidValue;
  }
  for (int s = NSEG; s < 2; ++s) maps.a[s] = maps.b[s] = maps.a[0];
  auto kernel = vit_rows_gemm_kernel<BN, NSEG, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int tiles = ((R + kRowTile - 1) / kRowTile) * col_tiles;
  kernel<<<std::min(tiles, sms), kRowsThreads, S::kSmem, st>>>(
      maps, epi, R, col_tiles, k[0] / kKTile, NSEG > 1 ? k[1] / kKTile : 0);
  return cudaGetLastError();
}

// the head outputs (bwd false: om from q|k|v) or dq | dk | dv and bqkv's
// frame partials (bwd: from q|k|v and dom), one block a (frame, head)
template <int D>
static cudaError_t launch_attention(bool bwd, const bf16* qkv, const bf16* dom, bf16* out,
                                   float* part, int N, int T, int W, int H, cudaStream_t st) {
  const int smem = (int)head_attn_smem(bwd, T, D);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t err = bwd ? cudaFuncSetAttribute(vit_rows_attn_bwd_kernel<D>, attr, smem)
                              : cudaFuncSetAttribute(vit_rows_attn_fwd_kernel<D>, attr, smem);
  if (err != cudaSuccess) return err;
  if (bwd) {
    vit_rows_attn_bwd_kernel<D><<<N * H, kHeadThreads, smem, st>>>(qkv, dom, out, part, T, W, H);
  } else {
    vit_rows_attn_fwd_kernel<D><<<N * H, kHeadThreads, smem, st>>>(qkv, out, T, W, H);
  }
  return cudaGetLastError();
}

template <int G>
static cudaError_t launch_rows_gelu(const bf16* n2, const bf16* dy, const bf16* w1t,
                                    const bf16* w2, int R, int W, int FF, const EpiGelu<G>& epi,
                                    cudaStream_t st) {
  const bf16* a[2] = {n2, dy};
  const bf16* b[2] = {w1t, w2};
  const int k[2] = {W, W};
  return launch_rows_gemm<128, 2>(a, b, k, R, FF / 128, epi, st);
}

// The weight-gradient products' splits of the R rows: as many as let their
// blocks (one a 128 x 256 output tile and split) fill the device's SMs once,
// and at most one for each kWgMinRows rows begun, so that a split's stages
// outweigh its block's start; whole 64-row steps a split (rows_per_split)
// but for a shorter last one. 0 when the device cannot be read.
constexpr int kWgMinRows = 4096;

static int wgrad_splits(int R, int W, int FF, int* rows_per_split) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const int out_tiles = (4 * W * W + 2 * W * FF) / (kWgK * kWgN);
  const int most = std::max(1, std::min(sms / out_tiles, (R + kWgMinRows - 1) / kWgMinRows));
  *rows_per_split = kWgRows * ((R + kWgRows * most - 1) / (kWgRows * most));
  return (R + *rows_per_split - 1) / *rows_per_split;
}

}  // namespace sd

// the floats of sd_vit_block_bwd_rows' weight-gradient partials on the
// current device (the scratch's last buffer); ints: N, T, W, FF. -1 when the
// device cannot be read.
extern "C" long long sd_vit_block_bwd_rows_partials(const int* ints) {
  const int W = ints[2], FF = ints[3];
  int rows = 0;
  const int splits = sd::wgrad_splits(ints[0] * ints[1], W, FF, &rows);
  return splits < 1 ? -1 : (long long)splits * (4LL * W * W + 2LL * W * FF);
}

#define SD_TRY(call)                                 \
  do {                                               \
    const cudaError_t e_ = (call);                   \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

// ptrs: x, dy, 12 weights (VitArgs order), 3 transposed (wqkv, wo, w1), dx,
//       dwqkv (W,3W), dwo (W,W), dw1 (W,FF), dw2 (FF,W), gvec (9W+FF),
//       n1, qkv, om, x2, n2, hg, dzc, dx2, da, dom, dqkv (row operands),
//       bqkv frame partials (N, 3W), tile partials [g1|be1] (tiles, 2W),
//       [bo|g2|be2] (tiles, 3W), b1 (tiles, FF), b2 (tiles, W), the weight-
//       gradient partials (sd_vit_block_bwd_rows_partials floats: the splits
//       (K, N) of each product in turn)
// ints: N, T, W, H, FF, GELU
extern "C" int sd_vit_block_bwd_rows(const void* const* ptrs, const int* ints, void* stream) {
  using namespace sd;
  auto B = [&](int i) { return static_cast<bf16*>(const_cast<void*>(ptrs[i])); };
  auto F = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const int N = ints[0], T = ints[1], W = ints[2], H = ints[3], FF = ints[4], gelu = ints[5];
  const int D = head_dim(W, H);
  if (D == 0 || T < 1 || N < 1 || W != kRowsWidth || FF < kWgN || FF % kWgN || gelu < 0 ||
      gelu > 3)
    return (int)cudaErrorInvalidValue;
  const int R = N * T, tiles = (R + kRowTile - 1) / kRowTile;
  int rows_per_split = 0;
  const int splits = wgrad_splits(R, W, FF, &rows_per_split);
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const bf16 *x = B(0), *dy = B(1);
  const bf16* w[12];
  for (int i = 0; i < 12; ++i) w[i] = B(2 + i);
  const bf16 *wqkv_t = B(14), *wo_t = B(15), *w1_t = B(16);
  bf16* dx = B(17);
  float* mats[4] = {F(18), F(19), F(20), F(21)};
  float* gvec = F(22);
  bf16 *n1 = B(23), *qkv = B(24), *om = B(25), *n2 = B(27), *hg = B(28), *dzc = B(29),
       *da = B(31), *dom = B(32), *dqkv = B(33);
  float *x2 = F(26), *dx2 = F(30), *p_qkv = F(34), *p_ln1 = F(35), *p_ln2 = F(36),
        *p_b1 = F(37), *p_b2 = F(38), *tpart = F(39);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1-3: n1, q|k|v, the head outputs
  vit_rows_ln_kernel<<<(R + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      x, w[0], w[1], n1, R, W);
  SD_TRY(cudaGetLastError());
  {
    const bf16* a[1] = {n1};
    const bf16* b[1] = {wqkv_t};
    const int k[1] = {W};
    SD_TRY((launch_rows_gemm<256, 1>(a, b, k, R, 3 * W / 256, EpiBiasBf16{qkv, w[3], 3 * W},
                                     st)));
  }
  SD_TRY(D == 32 ? launch_attention<32>(false, qkv, nullptr, om, nullptr, N, T, W, H, st)
                 : launch_attention<64>(false, qkv, nullptr, om, nullptr, N, T, W, H, st));
  // 4: x2 and n2
  {
    const bf16* a[1] = {om};
    const bf16* b[1] = {wo_t};
    const int k[1] = {W};
    SD_TRY((launch_rows_gemm<256, 1>(a, b, k, R, 1,
                                     EpiResidualLn{x, w[5], w[6], w[7], x2, n2}, st)));
  }
  // 5: hg, dzc and db1's partials
  switch (gelu) {
    case kGeluExact:
      SD_TRY(launch_rows_gelu<kGeluExact>(n2, dy, w1_t, w[10], R, W, FF,
                                          EpiGelu<kGeluExact>{w[9], hg, dzc, p_b1, FF}, st));
      break;
    case kGeluQuick:
      SD_TRY(launch_rows_gelu<kGeluQuick>(n2, dy, w1_t, w[10], R, W, FF,
                                          EpiGelu<kGeluQuick>{w[9], hg, dzc, p_b1, FF}, st));
      break;
    case kGeluPoly:
      SD_TRY(launch_rows_gelu<kGeluPoly>(n2, dy, w1_t, w[10], R, W, FF,
                                         EpiGelu<kGeluPoly>{w[9], hg, dzc, p_b1, FF}, st));
      break;
    default:
      SD_TRY(launch_rows_gelu<kGeluBf16>(n2, dy, w1_t, w[10], R, W, FF,
                                         EpiGelu<kGeluBf16>{w[9], hg, dzc, p_b1, FF}, st));
  }
  // 6: dx2, da and the bo / g2 / be2 / b2 partials
  {
    const bf16* a[1] = {dzc};
    const bf16* b[1] = {w[8]};
    const int k[1] = {FF};
    SD_TRY((launch_rows_gemm<256, 1>(a, b, k, R, 1,
                                     EpiLn2Bwd{x2, dy, w[6], dx2, da, p_ln2, p_b2}, st)));
  }
  // 7-8: dom, then dq | dk | dv and bqkv's partials
  {
    const bf16* a[1] = {da};
    const bf16* b[1] = {w[4]};
    const int k[1] = {W};
    SD_TRY((launch_rows_gemm<256, 1>(a, b, k, R, 1, EpiBiasBf16{dom, nullptr, W}, st)));
  }
  SD_TRY(D == 32 ? launch_attention<32>(true, qkv, dom, dqkv, p_qkv, N, T, W, H, st)
                 : launch_attention<64>(true, qkv, dom, dqkv, p_qkv, N, T, W, H, st));
  // 9: dx and the g1 / be1 partials
  {
    const bf16* a[1] = {dqkv};
    const bf16* b[1] = {w[2]};
    const int k[1] = {3 * W};
    SD_TRY((launch_rows_gemm<256, 1>(a, b, k, R, 1, EpiLn1Bwd{x, w[0], dx2, dx, p_ln1},
                                     st)));
  }
  // 10: dwqkv = n1^T dqkv, dwo = om^T da, dw1 = n2^T dzc, dw2 = hg^T dy over
  // the rows' splits; then every ordered sum: the four products' splits and
  // the vector gradients' partials (gvec: g1 0, be1 W, bqkv 2W, bo 5W, g2 6W,
  // be2 7W, b1 8W, b2 8W + FF)
  {
    WgradArgs g = {};
    const bf16* as[4] = {n1, om, n2, hg};
    const bf16* bs[4] = {dqkv, da, dzc, dy};
    const int Ks[4] = {W, W, W, FF}, Ns[4] = {3 * W, W, FF, W};
    size_t off = 0;
    g.first[0] = 0;
    for (int q = 0; q < 4; ++q) {
      if (!tile_map(&g.a[q], as[q], R, Ks[q], kWgRows) ||
          !tile_map(&g.b[q], bs[q], R, Ns[q], kWgRows) || Ks[q] % kWgK || Ns[q] % kWgN)
        return (int)cudaErrorInvalidValue;
      g.part[q] = tpart + off;
      off += (size_t)splits * Ks[q] * Ns[q];
      g.K[q] = Ks[q];
      g.N[q] = Ns[q];
      g.first[q + 1] = g.first[q] + (Ks[q] / kWgK) * (Ns[q] / kWgN) * splits;
    }
    g.R = R;
    g.rows_per_split = rows_per_split;
    g.splits = splits;
    SD_TRY(cudaFuncSetAttribute(vit_rows_wgrad_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem));
    vit_rows_wgrad_kernel<<<g.first[4], kRowsThreads, kWgSmem, st>>>(g);
    SD_TRY(cudaGetLastError());
  }
  const int KN[4] = {3 * W * W, W * W, W * FF, FF * W};
  SumJob sums[9];
  size_t off = 0;
  for (int q = 0; q < 4; ++q) {
    sums[q] = SumJob{tpart + off, mats[q], splits, KN[q]};
    off += (size_t)splits * KN[q];
  }
  sums[4] = SumJob{p_ln1, gvec, tiles, 2 * W};
  sums[5] = SumJob{p_qkv, gvec + 2 * W, N, 3 * W};
  sums[6] = SumJob{p_ln2, gvec + 5 * W, tiles, 3 * W};
  sums[7] = SumJob{p_b1, gvec + 8 * W, tiles, FF};
  sums[8] = SumJob{p_b2, gvec + 8 * W + FF, tiles, W};
  return launch_weight_grads(nullptr, 0, sums, 9, kWgRows * 32, st);
}
