"""The benchmark's yardstick: the operations and bytes of the policy's work,
and the published peaks of the card, frozen here so that no change to the
program can move them.

Every count is the unfused math at the given shapes: the matrix and attention
products (2 FLOPs a multiply-add), the same whatever kernel implements them.
Elementwise work (normalisation, activations, the solver update) and the
optimizer are not counted. A training step's backward counts twice the
forward's products, less the input gradient of the products whose input is
data (the three patch embeddings over the proprioceptive inputs, the ViT's
patch embedding of the frames, the denoiser's embedding of the noisy
chunk), which autograd does not form. Bytes count each input read once and
each output written once: activations and weights in bf16 (2 bytes), the
solver's noise and trajectories and the weight gradients in float32.

``bound``, ``attn_flops``, ``enc_layer_flops``,
``dec_layer_flops`` and ``decoder_pass_flops`` are copies of the kernel
table's arithmetic in the repository's ``chip_smoke.py``; ``PEAK_FLOPS`` is
the H100 table of ``soccerdiffusion_tpu_torch/utils/profiling.py``. The rest
extends them to the ViT block, the frame stack, the K/V projection, the pack
and training's backward.
"""

from __future__ import annotations

# Peak dense FLOP/s of one card, keyed by torch.cuda.get_device_name: NVIDIA's
# H100 Tensor Core GPU data sheet, dense rates (no sparsity) at the full power
# limit. "bf16" is bf16 / fp16 on the tensor cores.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12},  # SXM5
    "NVIDIA H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12},
}
# HBM bytes per second of the same cards (the same data sheet)
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12, "NVIDIA H100 PCIe": 2.0e12}

BF16, FP32 = 2, 4


def peaks(device_name: str) -> tuple[float, float] | None:
    """(bf16 FLOP/s, bytes/s) of a card, or None for a card not in the table."""
    if device_name not in PEAK_FLOPS:
        return None
    return PEAK_FLOPS[device_name]["bf16"], PEAK_BYTES[device_name]


def bound(flops: float, io_bytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the peak FLOP/s and the bytes over the HBM rate."""
    return max(flops / peak_flops, io_bytes / peak_bytes)


def attn_flops(tq, tk, e):  # scores and value sums over all heads
    return 4 * tq * tk * e


def enc_layer_flops(t, e, ff):  # pre-norm self-attention layer with an ff-wide MLP
    return 2 * t * e * 3 * e + attn_flops(t, t, e) + 2 * t * e * e + 4 * t * e * ff


def dec_layer_flops(p, s, e, ff):  # self-attention, cross-attention over s keys, MLP
    return 2 * p * e * 3 * e + attn_flops(p, p, e) + 6 * p * e * e + attn_flops(p, s, e) + 4 * p * e * ff


def decoder_pass_flops(cfg, s):  # one denoiser pass over s context keys + the step token
    p, j, e = cfg["trajectory_prediction_length"], cfg["num_joints"], cfg["hidden_dim"]
    return 4 * p * j * e + cfg["num_decoder_layers"] * dec_layer_flops(p, s + 1, e, e)


# ----------------------------------------------------------- the policy's shapes

def imu_dim(cfg) -> int:
    return 4 if cfg["imu_orientation_embedding_method"] == "quaternion" else 5


def proprio_stacks(cfg) -> list[tuple[int, int, int]]:
    """(tokens, input width of the patch embedding, layers) of each
    proprioceptive stack, in the context's order."""
    ps, out = cfg["encoder_patch_size"], []
    if cfg["use_action_history"]:
        out.append((cfg["action_context_length"] // ps, ps * cfg["num_joints"],
                    cfg["num_action_history_encoder_layers"]))
    if cfg["use_imu"]:
        out.append((cfg["imu_context_length"] // ps, ps * imu_dim(cfg), cfg["num_imu_encoder_layers"]))
    if cfg["use_joint_states"]:
        out.append((cfg["joint_state_context_length"] // ps, ps * cfg["num_joints"],
                    cfg["joint_state_encoder_layers"]))
    return out


def context_len(cfg) -> int:
    """S: the context tokens (the proprioceptive stacks, the frame tokens,
    the game-state token), without the diffusion step token."""
    s = sum(t for t, _, _ in proprio_stacks(cfg))
    s += cfg["image_context_length"] if cfg["use_images"] else 0
    return s + (1 if cfg["use_gamestate"] else 0)


def vit_tokens(cfg) -> int:
    return (cfg["image_resolution"] // cfg["vit_patch_size"]) ** 2


def vit_patch_dim(cfg) -> int:
    return cfg["vit_patch_size"] ** 2 * 3


def vit_block_flops(cfg) -> int:  # one ViT block over one frame
    w = cfg["vit_width"]
    return enc_layer_flops(vit_tokens(cfg), w, 4 * w)


def vit_frame_flops(cfg) -> int:
    """One frame through the per-frame ViT: patch embedding, the blocks,
    the head's Dense to the hidden width."""
    w = cfg["vit_width"]
    return (2 * vit_tokens(cfg) * vit_patch_dim(cfg) * w + cfg["vit_depth"] * vit_block_flops(cfg)
            + 2 * w * cfg["hidden_dim"])


def frame_stack_flops(cfg) -> int:
    """The image-frame sequence stack over one robot's frame tokens: the
    patch-1 embedding (hidden to hidden) and its layers (MLP width hidden)."""
    f, e = cfg["image_context_length"], cfg["hidden_dim"]
    return 2 * f * e * e + cfg["num_image_sequence_encoder_layers"] * enc_layer_flops(f, e, e)


def proprio_flops(cfg) -> int:
    """One robot's proprioceptive stacks: patch embeddings and layers."""
    e = cfg["hidden_dim"]
    return sum(2 * t * d * e + n * enc_layer_flops(t, e, e) for t, d, n in proprio_stacks(cfg))


def kv_proj_flops(cfg, s: int) -> int:
    """The cross-attention K/V projections of s memory tokens, every layer."""
    e = cfg["hidden_dim"]
    return cfg["num_decoder_layers"] * 4 * s * e * e


def step_pass_flops(cfg, s: int) -> int:
    """One denoiser pass against projected context K/V of s tokens: the
    chunk's embedding, every layer with the step token's own K/V
    projection, the output projection."""
    e = cfg["hidden_dim"]
    return decoder_pass_flops(cfg, s) + cfg["num_decoder_layers"] * 4 * e * e


def enc_layer_params(e: int, ff: int) -> int:
    return 4 * e * e + 4 * e + 2 * e * ff + ff + e + 4 * e


def dec_layer_params(e: int) -> int:
    return 8 * e * e + 8 * e + 2 * e * e + 2 * e + 6 * e


def decoder_params(cfg) -> int:
    p, j, e = cfg["trajectory_prediction_length"], cfg["num_joints"], cfg["hidden_dim"]
    return 2 * j * e + j + e + cfg["num_decoder_layers"] * dec_layer_params(e)


def proprio_params(cfg) -> int:
    e = cfg["hidden_dim"]
    return sum(d * e + e + n * enc_layer_params(e, e) for _, d, n in proprio_stacks(cfg)) + 4 * e


# ----------------------------------------------------------- serving

def serve_period_flops(cfg, steps: int, frames_per_period: int) -> int:
    """One robot's replan period: the new frames through the ViT, the
    context (proprioceptive stacks and the frame stack), the context K/V
    projection, ``steps`` denoiser passes."""
    s = context_len(cfg)
    total = proprio_flops(cfg) + kv_proj_flops(cfg, s) + steps * step_pass_flops(cfg, s)
    if cfg["use_images"]:
        total += frames_per_period * vit_frame_flops(cfg) + frame_stack_flops(cfg)
    return total


def context_encode_work(cfg, b: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the context encoder over b robots: float32 inputs,
    the bf16 context out, the stacks' bf16 weights."""
    s, e = context_len(cfg), cfg["hidden_dim"]
    inputs = sum(t * d for t, d, _ in proprio_stacks(cfg)) * FP32 + 8
    flops = b * proprio_flops(cfg)
    return flops, b * (inputs + s * e * BF16) + proprio_params(cfg) * BF16


def chunk_sample_work(cfg, b: int, steps: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the whole-chunk sampler over b robots: the context
    in (bf16), its K/V projection, ``steps`` passes, the noise in and the
    chunk out (float32), the decoder's bf16 weights and the step tokens."""
    s, e = context_len(cfg), cfg["hidden_dim"]
    p, j = cfg["trajectory_prediction_length"], cfg["num_joints"]
    flops = b * (kv_proj_flops(cfg, s) + steps * step_pass_flops(cfg, s))
    io = b * (s * e * BF16 + 2 * p * j * FP32) + decoder_params(cfg) * BF16 + steps * e * FP32
    return flops, io


def denoise_work(cfg, b: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the distilled pass over b robots: the projected
    context K/V (bf16), the noise and the weights read once, the trajectory
    written once. A copy of the K/V into another layout (the port's pack)
    is an intermediate of one implementation and is not counted."""
    s, e = context_len(cfg), cfg["hidden_dim"]
    p, j = cfg["trajectory_prediction_length"], cfg["num_joints"]
    kv = b * cfg["num_decoder_layers"] * 2 * s * e * BF16
    flops = b * step_pass_flops(cfg, s)
    io = kv + b * 2 * p * j * FP32 + decoder_params(cfg) * BF16
    return flops, io


# ----------------------------------------------------------- training

def data_input_flops(cfg) -> int:
    """One robot's products whose input is data (no input gradient)."""
    e = cfg["hidden_dim"]
    p, j = cfg["trajectory_prediction_length"], cfg["num_joints"]
    total = sum(2 * t * d * e for t, d, _ in proprio_stacks(cfg)) + 2 * p * j * e
    if cfg["use_images"]:
        total += cfg["image_context_length"] * 2 * vit_tokens(cfg) * vit_patch_dim(cfg) * cfg["vit_width"]
    return total


def train_forward_flops(cfg) -> int:
    """One robot's forward in training: every frame through the ViT, the
    context, the K/V projection of the memory (context and step token) and
    one denoiser pass over it."""
    s = context_len(cfg)
    p, j, e = cfg["trajectory_prediction_length"], cfg["num_joints"], cfg["hidden_dim"]
    total = proprio_flops(cfg) + kv_proj_flops(cfg, s + 1)
    total += 4 * p * j * e + cfg["num_decoder_layers"] * dec_layer_flops(p, s + 1, e, e)
    if cfg["use_images"]:
        total += cfg["image_context_length"] * vit_frame_flops(cfg) + frame_stack_flops(cfg)
    return total


def train_step_flops(cfg, b: int) -> int:
    """Forward and backward of one training step at batch b."""
    fwd = train_forward_flops(cfg)
    return b * (3 * fwd - data_input_flops(cfg))


def vit_block_work(cfg, frames: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one ViT block forward and backward over ``frames``
    frames: forward x in, y out; backward x and dy in, dx out (bf16), the
    weights in (bf16) each way, their gradients out (float32)."""
    w, t = cfg["vit_width"], vit_tokens(cfg)
    act = frames * t * w * BF16
    params = enc_layer_params(w, 4 * w)
    flops = 3 * frames * vit_block_flops(cfg)
    return flops, 2 * act + 3 * act + 2 * params * BF16 + params * FP32


def encoder_stack_work(cfg, b: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the fused encoder stacks of one training step,
    forward and backward: the three proprioceptive stacks' layers and the
    image-frame stack's, over b robots (their patch embeddings are not in
    the stack op)."""
    e = cfg["hidden_dim"]
    stacks = [(t, n) for t, _, n in proprio_stacks(cfg)]
    if cfg["use_images"]:
        stacks.append((cfg["image_context_length"], cfg["num_image_sequence_encoder_layers"]))
    flops = io = 0
    for t, n in stacks:
        flops += 3 * b * n * enc_layer_flops(t, e, e)
        act = b * t * e * BF16
        params = n * enc_layer_params(e, e)
        io += 2 * act + 3 * act + 2 * params * BF16 + params * FP32
    return flops, io


def decoder_layer_work(cfg, b: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the fused decoder layers of one training step,
    forward and backward, each layer projecting its memory's K/V (the
    context and the step token): x and the memory in, y out; backward x,
    the memory and dy in, dx and dmemory out (bf16); weights in (bf16) each
    way, their gradients out (float32)."""
    s = context_len(cfg) + 1
    p, e, n = cfg["trajectory_prediction_length"], cfg["hidden_dim"], cfg["num_decoder_layers"]
    flops = 3 * b * n * (dec_layer_flops(p, s, e, e) + 4 * s * e * e)
    x, mem = b * p * e * BF16, b * s * e * BF16
    params = dec_layer_params(e)
    io = n * ((x + mem + x) + (x + mem + x + x + mem) + 2 * params * BF16 + params * FP32)
    return flops, io
