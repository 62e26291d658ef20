// Fused pre-norm ViT block, forward and backward: one thread block per frame.
// The device code of fused_vit_block.cu's two entries; the instances of each
// head dim (the four GELUs, forward and backward) are compiled apart, in
// fused_vit_block_hd32.cu and fused_vit_block_hd64.cu, so that the two build
// side by side.
//
// Replaces soccerdiffusion_tpu/ops/fused_vit_block.py: make_vit_block_fn's
// forward (_fwd_impl; _make_fwd_kernel over _block_core, or the
// "headloop" layout's kernel, which computes the same function) and its
// backward (_bwd_impl; _make_bwd_kernel / _make_headloop_bwd_kernel).
//
// FORWARD (vit_block_fwd_kernel)
//
// Per frame of T tokens and width W, with H heads of D = W / H and an MLP of
// width FF:
//   x2 = x + attn(LN1(x)) @ wo + bo;  y = x2 + gelu(LN2(x2) @ w1 + b1) @ w2 + b2
// at the TPU kernel's rounding points: bf16 input and output, fp32
// LayerNorm (eps 1e-6), q|k|v rounded to bf16 after the bias, fp32 scores
// x 1/sqrt(D) and softmax with the probabilities rounded to bf16 before the
// value sum, the head outputs rounded to bf16, the out-projection added to
// the fp32 residual, z = LN2(x2) @ w1 + b1 in fp32 and hg = z * cdf(z)
// rounded to bf16, where cdf is the exact normal CDF (erff) or quick-GELU's
// sigmoid(1.702 z) (or hg the "poly" polynomial, or the "bf16" chain:
// train_common.cuh:Gelu); the output rounded once.
//
// Bound on the H100: 2 T (3 W^2 + W^2 + 2 W FF) + 4 T^2 W FLOP per frame =
// 105 MFLOP at T=64, W=256, FF=1024 (67 GFLOP per launch at N=640 frames),
// against 2 x 32 KB of frame bytes and 1.5 MB of weights that stay
// L2-resident: compute-bound, 0.068 ms at the 989 TFLOP/s bf16 tensor-core
// peak. The first port did its products as scalar fp32 FMAs (~14 TFLOP/s,
// 4.676 ms at N=640 on an H100 80GB HBM3 at 700 W; PERF.md); every product
// now runs on the tensor cores (mma.sync m16n8k16 bf16, mma.cuh). What bounds
// it now: one frame per block (16 warps a SM, 194 KB of shared memory), B
// fragments read from L2 with 32-bit loads (each weight once per frame), and
// the scalar LayerNorm passes.
//
// Design: the whole frame lives in shared memory -- the fp32 residual
// (T, W) here, and the bf16 operands of encoder_layer.cuh:layer_fwd_smem,
// which the encoder stack's forward shares: the LayerNorm / attention output
// (T, W + 8) and q|k|v (T, 3W + 8); 194 KB at the flagship shape. Rows are
// padded by 8 elements so that the 8 rows of an ldmatrix hit 8 different
// bank quads. The products are mma_dense over 64-row x 16-column warp items
// (the frame's 64 rows are 4 m16 tiles, the block's 16 warps split the
// output columns, so each weight is read from L2 once per frame), A read
// with ldmatrix; the weights are read transposed, (out, in), so that a B
// fragment is two adjacent bf16. Attention runs per (head, 16-query tile)
// warp item with the scores in registers: row max and sum by quad shuffles,
// the probabilities normalised, rounded to bf16 and fed as the A fragment of
// the value product (the rounding point of the scalar kernel, no (T, T)
// tile in shared memory); k and v^T fragments by ldmatrix. The MLP runs over
// FF-column chunks of 256: hidden chunk -> GELU -> bf16 into the q|k|v
// region -> its share of the second product added into the fp32 residual
// (b2 with the first chunk). Not carried over from the TPU kernel: the
// lane-masked head stacking (_masks/_mask4), the (F, HT, T) score layout,
// the frame-block grid (one block per frame), the polynomial erf.
#pragma once

#include "encoder_layer.cuh"

namespace sd {

struct VitArgs {
  const bf16* x;  // (N, T, W)
  // g1 be1 wqkv (W, 3W) bqkv wo (W, W) bo g2 be2 w1 (W, FF) b1 w2 (FF, W) b2
  const bf16* w[12];
  const bf16* wt[4];  // transposed wqkv (3W, W), wo (W, W), w1 (FF, W), w2 (W, FF)
  bf16* y;            // (N, T, W)
  int N, T, W, H, FF;
};

// shared-memory bytes of one frame: the fp32 residual and layer_fwd_smem's
// bf16 operands
__host__ __device__ inline size_t vit_smem_bytes(int T, int W) {
  return 4 * (size_t)T * W + fwd_smem_bytes(T, W);
}

template <int D, int G>
__global__ void __launch_bounds__(kFwdThreads) vit_block_fwd_kernel(VitArgs a) {
  extern __shared__ float4 smem4[];
  const int T = a.T, W = a.W;
  float* h = reinterpret_cast<float*>(smem4);      // (T, W) fp32 residual
  bf16* act = reinterpret_cast<bf16*>(h + T * W);  // (T, W + 8)
  bf16* qkv = act + T * (W + 8);                   // (T, 3W + 8)
  const bf16* x = a.x + (size_t)blockIdx.x * T * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) h[i] = tof(x[i]);
  __syncthreads();
  const EncLayer w{a.w[0], a.w[1], a.w[2],  a.w[3],  a.w[4],  a.w[5],  a.w[6],  a.w[7],
                   a.w[8], a.w[9], a.w[10], a.w[11], a.wt[0], a.wt[1], a.wt[2], a.wt[3]};
  layer_fwd_smem<D, G>(w, h, h, act, qkv, T, W, a.FF, a.H);
  bf16* y = a.y + (size_t)blockIdx.x * T * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) y[i] = __float2bfloat16(h[i]);
}

// BACKWARD (vit_block_bwd_kernel)
//
// At W = 256 the wrapper takes vit_block_rows.cu's row-tiled kernels instead
// (ops/fused_vit_block.py:row_tiled); this kernel serves the other widths.
// The block is one pre-norm encoder layer, so the backward is the encoder
// stack's layer (encoder_layer.cuh) at L = 1 with the block's GELU: one
// thread block per frame recomputes the frame's forward internals from x
// (the only residual, as in the JAX custom_vjp) and runs the hand-derived
// backward at the TPU kernel's rounding points -- dhg and the GELU gradient
// (erff, quick-GELU's s (1 + 1.702 z (1 - s)) or the polynomial's) in fp32
// (the "bf16" GELU: dz rounded in its bf16 chain), dzc, dq / dk /
// dv and dom rounded to bf16, fp32 LayerNorm backwards, dx rounded once.
// Its intermediates (the (T, FF) MLP hidden does not fit shared memory
// beside the rest: 256 KB fp32 at the flagship shape) live in a per-frame
// global workspace that stays L2-resident while the block runs; the
// attention backward's softmax statistics (3 H T floats) sit in shared
// memory. It writes dx, the bf16
// operands of the four weight-gradient products per row, (n1, dqkv) (om,
// da) (n2, dzc) (hg, gc), and per-frame fp32 partials of the eight vector
// gradients; weight_grads.cu then sums both over the N T rows and N frames
// in a fixed order (no atomics: the TPU kernel's `+=` into the weight
// gradients across its sequential grid would race across thread blocks).
//
// Bound on the H100: the recompute, the input gradients and the four
// weight-gradient products are ~3x the forward's FLOPs, ~315 MFLOP per frame
// at T=64, W=256, FF=1024 (202 GFLOP at N=640 frames): compute-bound at the
// bf16 tensor-core peak (0.2 ms). Every product now runs on the tensor cores
// (encoder_layer.cuh's mma products and attention, weight_grads.cu's
// tdot_kernel); what bounds it now is the ~1 MB per frame of workspace and
// saved rows written and read back through L2 by one 8-warp block per SM
// (255 registers a thread for the attention tiles), and the scalar
// LayerNorm and column-sum passes (PERF.md).
struct VitBwdArgs {
  const bf16* x;   // (N, T, W)
  const bf16* dy;  // (N, T, W)
  const bf16* w[12];
  const bf16* wt[4];  // transposed wqkv (3W, W), wo (W, W), w1 (FF, W), w2 (W, FF)
  bf16* dx;           // (N, T, W)
  float* ws32;        // (N, ws32_stride) per-frame fp32 workspace
  bf16* wsbf;         // (N, wsbf_stride) per-frame bf16 workspace
  bf16* saved;        // (N T, 8W + 2FF) weight-gradient operand rows
  float* vpart;       // (N, 9W + FF) per-frame vector-gradient partials
  int N, T, W, H, FF, ws32_stride, wsbf_stride;
};

template <int D, int G>
__global__ void __launch_bounds__(kThreads) vit_block_bwd_kernel(VitBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* stats = reinterpret_cast<float*>(smem4);
  const int f = blockIdx.x, T = a.T, W = a.W, FF = a.FF, WS = 8 * W + 2 * FF;
  EncWs s;
  size_t n32, nbf;
  carve(T, W, FF, a.ws32 + (size_t)f * a.ws32_stride, a.wsbf + (size_t)f * a.wsbf_stride, &s,
        &n32, &nbf);
  const size_t tw = (size_t)T * W;
  const bf16 *x = a.x + f * tw, *dy = a.dy + f * tw;
  // the frame's fp32 input goes to dx2, which the backward writes only after
  // its last read; dL/dy to g
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) {
    s.dx2[i] = tof(x[i]);
    s.g[i] = tof(dy[i]);
  }
  __syncthreads();
  const EncLayer w{a.w[0], a.w[1], a.w[2],  a.w[3],  a.w[4],  a.w[5],  a.w[6],  a.w[7],
                   a.w[8], a.w[9], a.w[10], a.w[11], a.wt[0], a.wt[1], a.wt[2], a.wt[3]};
  bf16* sv = a.saved + (size_t)f * T * WS;
  layer_fwd<D, G>(w, s, sv, WS, s.dx2, s.tmp, T, W, FF, a.H);
  layer_bwd<D, G>(w, s, sv, WS, stats, a.vpart + (size_t)f * (9 * W + FF), T, W, FF, a.H);
  bf16* dx = a.dx + f * tw;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) dx[i] = __float2bfloat16(s.g[i]);
}

// The launches of one head dim's instances (the GELU picks one): defined
// with their instances in fused_vit_block_hd{32,64}.cu, called by the
// entries of fused_vit_block.cu.
template <int D>
cudaError_t launch_vit_fwd_impl(const VitArgs& a, int gelu, size_t smem, cudaStream_t st) {
  void (*const kernels[4])(VitArgs) = {vit_block_fwd_kernel<D, kGeluExact>,
                                       vit_block_fwd_kernel<D, kGeluQuick>,
                                       vit_block_fwd_kernel<D, kGeluPoly>,
                                       vit_block_fwd_kernel<D, kGeluBf16>};
  cudaError_t err = cudaFuncSetAttribute(kernels[gelu],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernels[gelu]<<<a.N, kFwdThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_vit_bwd_impl(const VitBwdArgs& a, int gelu, size_t smem, cudaStream_t st) {
  void (*const kernels[4])(VitBwdArgs) = {vit_block_bwd_kernel<D, kGeluExact>,
                                          vit_block_bwd_kernel<D, kGeluQuick>,
                                          vit_block_bwd_kernel<D, kGeluPoly>,
                                          vit_block_bwd_kernel<D, kGeluBf16>};
  cudaError_t err = cudaFuncSetAttribute(kernels[gelu],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernels[gelu]<<<a.N, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_vit_fwd_hd32(const VitArgs& a, int gelu, size_t smem, cudaStream_t st);
cudaError_t launch_vit_fwd_hd64(const VitArgs& a, int gelu, size_t smem, cudaStream_t st);
cudaError_t launch_vit_bwd_hd32(const VitBwdArgs& a, int gelu, size_t smem, cudaStream_t st);
cudaError_t launch_vit_bwd_hd64(const VitBwdArgs& a, int gelu, size_t smem, cudaStream_t st);

}  // namespace sd
