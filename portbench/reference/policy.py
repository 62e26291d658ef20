"""A plain PyTorch reference of the diffusion policy, its DDIM sampler, its
closed-loop plant and controller, and its training step with AdamW.

Written from the policy's published description (bit-bots/SoccerDiffusion:
pre-norm GELU transformer encoders over each proprioceptive modality, a
ViT over camera frames and a frame-sequence encoder, a game-state token,
a cross-attending transformer decoder that predicts the noise of a chunk of
joint commands, DDIM with the squared-cosine schedule). It imports nothing
but torch, numpy and the standard library, and takes only what the
benchmark made: the weights by name, the normaliser, the inputs and the
noise. Everything else (the context, the K/V, the schedule, the frames'
tokens) it works out again.

``prec`` is the precision of every product's operands: "fp32" (float32
throughout; call ``exact_float32`` first so that no product runs in TF32)
or "fp8", the control: each operand of every matrix and attention product
rounded to float8 e4m3 with a per-tensor scale, accumulated in float32 (in
training the backward's products take the rounded operands; the gradients
themselves pass in float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
FP8_MAX = 448.0
JOINT_HEADS = 4  # heads of each proprioceptive stack
FRAME_HEADS = 8  # heads of the image-frame sequence stack
VIT_HEADS = 4


def exact_float32() -> None:
    """No product in TF32: float32 means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's operand in ``prec`` (returned as float32)."""
    x = x.float()
    if prec == "fp32":
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())  # the rounded value; the gradient passes in float32


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return rnd(a, prec) @ rnd(b, prec)


def linear(x, w, b, prec):
    """x @ w.T + b for a (out, in) weight."""
    y = mm(x, w.t(), prec)
    return y if b is None else y + b.float()


def layer_norm(x, g, b):
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), LN_EPS)


def sinusoidal_table(max_len: int, d: int) -> torch.Tensor:
    """pe[:, 0::2] = sin(pos w_i), pe[:, 1::2] = cos(pos w_i), w_i =
    exp(-ln(1e4) 2i / d), in float64, cast to float32."""
    pe = np.zeros((max_len, d), dtype=np.float64)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


def attention(xq, xkv, W, p, heads, prec, kv=None):
    """Multi-head attention of the module at prefix ``p``: queries from xq,
    keys and values from xkv (or the given (k, v) (B, S, E))."""
    q = linear(xq, W[p + "q_proj.weight"], W[p + "q_proj.bias"], prec)
    if kv is None:
        kv = (linear(xkv, W[p + "k_proj.weight"], W[p + "k_proj.bias"], prec),
              linear(xkv, W[p + "v_proj.weight"], W[p + "v_proj.bias"], prec))
    k, v = kv
    b, tq, e = q.shape
    d = e // heads
    split = lambda x: x.reshape(b, x.shape[1], heads, d).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(d)
    o = mm(torch.softmax(scores, dim=-1), v, prec)
    o = o.transpose(1, 2).reshape(b, tq, e)
    return linear(o, W[p + "out_proj.weight"], W[p + "out_proj.bias"], prec)


def gelu(z, kind: str):
    return z * torch.sigmoid(1.702 * z) if kind == "quick" else F.gelu(z)


def mlp(x, W, p, prec, kind="exact"):
    z = linear(x, W[p + "linear1.weight"], W[p + "linear1.bias"], prec)
    return linear(gelu(z, kind), W[p + "linear2.weight"], W[p + "linear2.bias"], prec)


def encoder_layer(x, W, p, heads, prec, kind="exact"):
    h = layer_norm(x, W[p + "norm1.weight"], W[p + "norm1.bias"])
    x = x + attention(h, h, W, p + "self_attn.", heads, prec)
    h = layer_norm(x, W[p + "norm2.weight"], W[p + "norm2.bias"])
    return x + mlp(h, W, p + "mlp.", prec, kind)


def sequence_encoder(x, W, p, heads, layers, prec):
    """(B, T, C) -> (B, T / patch, E): the non-overlapping patch conv over
    time, the sinusoidal positions, the pre-norm layers."""
    w, bias = W[p + "embedding.proj.weight"], W[p + "embedding.proj.bias"]  # (E, C, patch)
    e, c, patch = w.shape
    b, t, _ = x.shape
    patches = x.float().reshape(b, t // patch, patch, c).transpose(2, 3).reshape(b, t // patch, c * patch)
    h = linear(patches, w.reshape(e, c * patch), bias, prec)
    h = h + sinusoidal_table(h.shape[1], e).to(h.device)
    for i in range(layers):
        h = encoder_layer(h, W, f"{p}encoder.layers.{i}.", heads, prec)
    return h


def proprio_context(W, cfg, batch, prec) -> list[torch.Tensor]:
    """The context pieces before the image tokens: action history, IMU,
    joint states, each through its stack."""
    out = []
    if cfg["use_action_history"]:
        out.append(sequence_encoder(batch["joint_command_history"], W, "action_history_encoder.seq.",
                                    JOINT_HEADS, cfg["num_action_history_encoder_layers"], prec))
    if cfg["use_imu"]:
        out.append(sequence_encoder(batch["rotation"], W, "imu_encoder.seq.", JOINT_HEADS,
                                    cfg["num_imu_encoder_layers"], prec))
    if cfg["use_joint_states"]:
        out.append(sequence_encoder(batch["joint_state"], W, "joint_states_encoder.seq.",
                                    JOINT_HEADS, cfg["joint_state_encoder_layers"], prec))
    return out


def context(W, cfg, batch, prec, frame_tokens=None) -> torch.Tensor:
    """(B, S, E) context tokens: proprioceptive stacks, the frame-sequence
    stack over ``frame_tokens`` (B, F, E), the game-state token."""
    pieces = proprio_context(W, cfg, batch, prec)
    if cfg["use_images"]:
        pieces.append(sequence_encoder(frame_tokens, W, "image_sequence_encoder.seq.", FRAME_HEADS,
                                       cfg["num_image_sequence_encoder_layers"], prec))
    if cfg["use_gamestate"]:
        pieces.append(W["game_state_encoder.embedding.weight"].float()[batch["game_state"].long()][:, None])
    return torch.cat(pieces, dim=1)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def patchify(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, (H/P)(W/P), P*P*C): patches row-major, each
    patch's pixels row-major with the channels last."""
    n, h, w, c = frames.shape
    x = frames.reshape(n, h // patch, patch, w // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // patch) * (w // patch), patch * patch * c)


def normalise_u8(patches: torch.Tensor) -> torch.Tensor:
    """Raw uint8 pixels in the patch layout (channels last) -> ImageNet-
    normalised float32."""
    reps = patches.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN, device=patches.device).repeat(reps)
    std = torch.tensor(IMAGENET_STD, device=patches.device).repeat(reps)
    return (patches.float() / 255.0 - mean) / std


def vit_frames(W, cfg, patches, prec) -> torch.Tensor:
    """(N, patches, P*P*3) normalised pixels -> (N, E) per-frame tokens:
    patch embedding, positions, the pre-norm blocks (4 heads, MLP 4x, the
    configured GELU), mean over the patches, LayerNorm, Dense."""
    p = "image_sequence_encoder.image_encoder."
    kind = "quick" if cfg["vit_fused_gelu"] in ("quick", "bf16") else "exact"
    x = mm(patches, W[p + "patch_kernel"], prec) + W[p + "patch_bias"].float()
    x = x + sinusoidal_table(x.shape[1], x.shape[2]).to(x.device)
    for i in range(cfg["vit_depth"]):
        x = encoder_layer(x, W, f"{p}blocks.layers.{i}.", VIT_HEADS, prec, kind)
    x = layer_norm(x.mean(dim=1), W[p + "norm.weight"], W[p + "norm.bias"])
    return linear(x, W[p + "fc.weight"], W[p + "fc.bias"], prec)


def step_token(W, e: int, t: torch.Tensor) -> torch.Tensor:
    """(B, 1, E): [sin(t w), cos(t w), the learned token], w_i =
    exp(-i ln(1e4) / (E/4 - 1))."""
    half = e // 4
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freqs[None]
    tok = W["step_encoding.token"].float().expand(t.shape[0], e // 2)
    return torch.cat([torch.sin(ang), torch.cos(ang), tok], dim=-1)[:, None]


def context_kv(W, cfg, ctx, prec) -> list:
    """Each decoder layer's cross-attention K/V of the context."""
    out = []
    for i in range(cfg["num_decoder_layers"]):
        p = f"diffusion_action_generator.decoder.layers.{i}.cross_attn."
        out.append((linear(ctx, W[p + "k_proj.weight"], W[p + "k_proj.bias"], prec),
                    linear(ctx, W[p + "v_proj.weight"], W[p + "v_proj.bias"], prec)))
    return out


def decoder(W, cfg, kv, x, prec) -> torch.Tensor:
    """The denoiser's decoder over chunk x (B, P, J): embedding, positions,
    the pre-norm layers cross-attending a memory whose K/V (the step token's
    included) are ``kv``, the output projection."""
    g = "diffusion_action_generator."
    e = cfg["hidden_dim"]
    h = linear(x, W[g + "embedding.weight"], W[g + "embedding.bias"], prec)
    h = h + sinusoidal_table(cfg["trajectory_prediction_length"], e).to(h.device)[: h.shape[1]]
    heads = cfg["num_decoder_heads"]
    for i, (k, v) in enumerate(kv):
        p = f"{g}decoder.layers.{i}."
        n = layer_norm(h, W[p + "norm1.weight"], W[p + "norm1.bias"])
        h = h + attention(n, n, W, p + "self_attn.", heads, prec)
        n = layer_norm(h, W[p + "norm2.weight"], W[p + "norm2.bias"])
        h = h + attention(n, None, W, p + "cross_attn.", heads, prec, kv=(k, v))
        n = layer_norm(h, W[p + "norm3.weight"], W[p + "norm3.bias"])
        h = h + mlp(n, W, p + "mlp.", prec)
    return linear(h, W[g + "fc_out.weight"], W[g + "fc_out.bias"], prec)


def denoise(W, cfg, kv, x, t, prec) -> torch.Tensor:
    """The noise predicted for chunk x (B, P, J) at timesteps t (B,), the
    memory being the context (its K/V ``kv``) and the step token."""
    tok = step_token(W, cfg["hidden_dim"], t)
    full = []
    for i, (k, v) in enumerate(kv):
        c = f"diffusion_action_generator.decoder.layers.{i}.cross_attn."
        full.append((torch.cat([k, linear(tok, W[c + "k_proj.weight"], W[c + "k_proj.bias"], prec)], 1),
                     torch.cat([v, linear(tok, W[c + "v_proj.weight"], W[c + "v_proj.bias"], prec)], 1)))
    return decoder(W, cfg, full, x, prec)


# ----------------------------------------------------------- diffusion

def alphas_cumprod(num_train_timesteps: int = 1000) -> np.ndarray:
    """The squared-cosine ("squaredcos_cap_v2") schedule's alpha-bar:
    betas in float64 stored as float32, their cumulative product in
    float64 stored as float32."""
    f = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    n = num_train_timesteps
    betas = np.array([min(1.0 - f((i + 1) / n) / f(i / n), 0.999) for i in range(n)],
                     dtype=np.float64).astype(np.float32)
    return np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)


def ddim_sample(W, cfg, ctx, noise, steps: int, prec, num_train_timesteps: int = 1000):
    """Deterministic DDIM (eta 0, "leading" spacing, no clipping, alpha-bar
    1 past t = 0) from ``noise`` over ``steps`` steps."""
    abar = alphas_cumprod(num_train_timesteps)
    ratio = num_train_timesteps // steps
    kv = context_kv(W, cfg, ctx, prec)
    x = noise.float()
    b = x.shape[0]
    for t in (np.arange(steps) * ratio)[::-1]:
        eps = denoise(W, cfg, kv, x, torch.full((b,), int(t), device=x.device), prec)
        a_t = torch.tensor(float(abar[t]), dtype=torch.float32)
        a_p = torch.tensor(float(abar[t - ratio]) if t - ratio >= 0 else 1.0, dtype=torch.float32)
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps
    return x


def sample_chunk(W, cfg, ctx, noise, norm_mean, norm_std, steps: int, distilled: bool, prec):
    """The denormalised chunk: DDIM over ``steps`` steps, or the distilled
    student's one pass at t = 0, whose output is the trajectory."""
    if distilled:
        kv = context_kv(W, cfg, ctx, prec)
        x = denoise(W, cfg, kv, noise, torch.zeros(noise.shape[0], dtype=torch.long,
                                                   device=noise.device), prec)
    else:
        x = ddim_sample(W, cfg, ctx, noise, steps, prec)
    return x * norm_std.float() + norm_mean.float()


# ----------------------------------------------------------- closed loop

TWO_PI = 2.0 * math.pi


def model_batch(state: dict) -> dict:
    """The model's inputs from the controller's buffers: joints in
    [-pi, pi] shifted into [0, 2 pi) by (x + 3 pi) mod 2 pi."""
    shift = lambda x: torch.remainder(x + 3 * math.pi, TWO_PI)
    return {"joint_command_history": shift(state["joint_command_history"]),
            "joint_state": shift(state["joint_state_history"]),
            "rotation": state["imu_history"], "game_state": state["game_state"]}


def plant_rows(positions, phase, executed, alpha: float, imu_dim: int):
    """The first-order joint-tracking stub over the executed ticks, by its
    recurrence p <- p + alpha (target - p), target = command - pi; the IMU
    stub's quaternion (or five-dim) rows at phase + 0.02 k. Returns the
    joint rows, the IMU rows, the last position and phase."""
    rows, p = [], positions.float()
    for k in range(executed.shape[1]):
        p = p + alpha * ((executed[:, k].float() - math.pi) - p)
        rows.append(p)
    ticks = torch.arange(1, executed.shape[1] + 1, device=phase.device, dtype=torch.float32)
    phases = phase.float()[:, None] + 0.02 * ticks[None]
    if imu_dim == 4:
        half = 0.05 * torch.sin(phases)
        z = torch.zeros_like(half)
        imus = torch.stack([torch.sin(half), z, z, torch.cos(half)], dim=-1)
    else:
        angle = 0.1 * torch.sin(phases)
        one, z = torch.ones_like(angle), torch.zeros_like(angle)
        imus = torch.stack([one, z, z, torch.sin(angle), torch.cos(angle)], dim=-1)
    return torch.stack(rows, 1), imus, p, phases[:, -1]


def roll(buffer, rows):
    return torch.cat([buffer.float(), rows.float()], dim=1)[:, rows.shape[1]:]


def controller_update(state: dict, executed, alpha: float, imu_dim: int) -> dict:
    """The buffers and plant after a period that executed ``executed``
    (B, k, J) in [0, 2 pi): the commands enter the action history less pi,
    the plant's joint rows and IMU rows are observed."""
    js, imu, pos, phase = plant_rows(state["positions"], state["phase"], executed, alpha, imu_dim)
    return {"joint_command_history": roll(state["joint_command_history"], executed.float() - math.pi),
            "joint_state_history": roll(state["joint_state_history"], js),
            "imu_history": roll(state["imu_history"], imu), "positions": pos, "phase": phase,
            "game_state": state["game_state"]}


def camera_frames(phases: torch.Tensor, res: int) -> torch.Tensor:
    """The stub camera's frames at the given phases (B, n): sin(ramp_y +
    ramp_x + phase) on every channel, (B, n, res, res, 3)."""
    ramp = torch.linspace(-1.0, 1.0, res, device=phases.device)
    base = ramp[:, None] + ramp[None, :]
    frames = torch.sin(base[None, None] + phases[:, :, None, None].float())
    return frames[..., None].expand(*frames.shape, 3)


def frame_phases(phase: torch.Tensor, frames: int, per_period: int) -> torch.Tensor:
    """The phases of the ``frames`` newest camera frames before a period
    that starts at ``phase``: one every 5 ticks (0.1 of phase), the newest
    at ``phase`` (the last tick of the previous period)."""
    offsets = 0.1 * torch.arange(frames - 1, -1, -1, device=phase.device, dtype=torch.float32)
    return phase.float()[:, None] - offsets[None]


# ----------------------------------------------------------- training

def lr_at_step(lr: float, total_steps: int, step: int) -> float:
    """The one-cycle cosine schedule: from lr/25 up to lr over the first
    30% of the steps, down to lr/2.5e5 by the end."""
    warm, total = int(0.3 * total_steps), int(total_steps)
    start, peak, final = lr / 25.0, lr, lr / 25.0 / 1e4
    if step >= total:
        return final
    lo, hi, a, b = (0, warm, start, peak) if step < warm else (warm, total, peak, final)
    pct = (step - lo) / (hi - lo)
    return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def train_loss_sum(W, cfg, batch, t, noise, norm_mean, norm_std, prec) -> torch.Tensor:
    """The sum over rows of the squared error of the predicted noise (the
    step's loss is its mean): targets normalised, forward diffusion at t,
    the frames (raw uint8 patches with a valid mask) through the ViT."""
    abar = torch.from_numpy(alphas_cumprod()).to(t.device)[t.long()][:, None, None]
    x0 = (batch["joint_command"].float() - norm_mean.float()) / norm_std.float()
    noisy = torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise.float()
    frame_tokens = None
    if cfg["use_images"]:
        u8, valid = batch["image_u8"], batch["image_valid"].float()
        b, f = u8.shape[:2]
        pix = normalise_u8(u8.reshape(b * f, *u8.shape[2:])) * valid.reshape(b * f, 1, 1)
        frame_tokens = vit_frames(W, cfg, pix, prec).reshape(b, f, -1)
    ctx = context(W, cfg, batch, prec, frame_tokens)
    tok = step_token(W, cfg["hidden_dim"], t)
    memory = torch.cat([ctx, tok], dim=1)
    kv = context_kv(W, cfg, memory, prec)
    eps = decoder(W, cfg, kv, noisy, prec)
    return torch.sum((eps - noise.float()) ** 2)


def train_steps(W0: dict, cfg, batches, draws, norm_mean, norm_std, lr, total_steps,
                weight_decay, prec, rows: int):
    """``len(batches)`` AdamW steps (betas 0.9 / 0.999, eps 1e-8, decoupled
    weight decay, the one-cycle learning rate) from the weights ``W0``,
    each step's loss the mean squared error over the batch, its gradient
    accumulated over blocks of ``rows`` rows. ``draws`` are the steps'
    (t, noise). Returns (losses, the first step's gradients, the weights
    after the steps), the tensors by name."""
    W = {k: v.detach().float().clone().requires_grad_(True) for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, first = [], None
    for step, (batch, (t, noise)) in enumerate(zip(batches, draws)):
        n = noise.numel()
        total = 0.0
        for w in W.values():
            w.grad = None
        for lo in range(0, noise.shape[0], rows):
            part = {k: x[lo: lo + rows] for k, x in batch.items()}
            loss = train_loss_sum(W, cfg, part, t[lo: lo + rows], noise[lo: lo + rows],
                                  norm_mean, norm_std, prec) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = {k: (w.grad if w.grad is not None else torch.zeros_like(w)).detach()
                 for k, w in W.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        rate = lr_at_step(lr, total_steps, step)
        with torch.no_grad():
            c1, c2 = 1.0 - 0.9 ** (step + 1), 1.0 - 0.999 ** (step + 1)
            for k, w in W.items():
                g = grads[k]
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                w.mul_(1.0 - rate * weight_decay)
                w.sub_(rate * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + 1e-8))
    return losses, first, {k: w.detach() for k, w in W.items()}
