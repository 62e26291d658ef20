"""Typed configuration: the port's own ``ModelConfig``, ``TrainConfig`` and
``Config``, with the field names, defaults, checks and flat-dict / YAML
round trip of ``soccerdiffusion_tpu/config.py`` (so one YAML file and one
checkpoint hyperparameter dict configure both packages).

``check_supported`` rejects the settings this port does not carry yet;
ROADMAP.md lists when each comes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

__all__ = ["Config", "ModelConfig", "TrainConfig", "check_remat_image_encoder",
           "check_serving_supported", "check_supported"]

CANONICAL_JOINT_NAMES_22 = (
    "HeadPan", "HeadTilt", "LAnklePitch", "LAnkleRoll", "LElbow", "LElbowYaw", "LHipPitch",
    "LHipRoll", "LHipYaw", "LKnee", "LShoulderPitch", "LShoulderRoll", "RAnklePitch",
    "RAnkleRoll", "RElbow", "RElbowYaw", "RHipPitch", "RHipRoll", "RHipYaw", "RKnee",
    "RShoulderPitch", "RShoulderRoll",
)
# the 20-joint subset of every shipped config (no elbow yaw)
CANONICAL_JOINT_NAMES_20 = tuple(n for n in CANONICAL_JOINT_NAMES_22 if not n.endswith("ElbowYaw"))

VALID_IMAGE_ENCODERS = ("resnet18", "resnet50", "vit", "swin_transformer_tiny", "swin_transformer_small")
VALID_SEQUENCE_ENCODERS = ("transformer", "none")
VALID_IMU_METHODS = ("quaternion", "five_dim")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (the JAX package's ``ModelConfig``; its
    docstrings explain the TPU knobs)."""

    num_joints: int = 20
    hidden_dim: int = 128
    trajectory_prediction_length: int = 10
    encoder_patch_size: int = 1
    use_action_history: bool = True
    num_action_history_encoder_layers: int = 2
    action_context_length: int = 100
    use_imu: bool = True
    imu_orientation_embedding_method: str = "quaternion"
    num_imu_encoder_layers: int = 2
    imu_context_length: int = 100
    use_joint_states: bool = True
    joint_state_encoder_layers: int = 2
    joint_state_context_length: int = 100
    use_images: bool = True
    image_encoder_type: str = "resnet18"
    image_sequence_encoder_type: str = "transformer"
    num_image_sequence_encoder_layers: int = 1
    image_context_length: int = 10
    image_use_final_avgpool: bool = False
    image_resolution: int = 224
    use_gamestate: bool = True
    num_decoder_layers: int = 4
    num_decoder_heads: int = 4
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    aux_cue_head: bool = False
    attention_impl: str = "auto"
    remat_image_encoder: bool | str = False
    vit_patch_size: int = 16
    vit_width: int = 192
    vit_depth: int = 6
    vit_fused_block: bool = False
    vit_fused_block_frames: int = 8
    vit_fused_gelu: str = "exact"
    vit_fused_layout: str = "stacked"
    encoder_fused_block: bool = False
    encoder_fused_block_rows: int = 16
    encoder_fused_stack: bool = False
    remat_decoder: bool = False
    decoder_fused_block: bool = False
    decoder_fused_block_rows: int = 32

    def __post_init__(self) -> None:
        if self.imu_orientation_embedding_method not in VALID_IMU_METHODS:
            raise ValueError(f"unknown imu_orientation_embedding_method: {self.imu_orientation_embedding_method}")
        if self.use_images and self.image_encoder_type not in VALID_IMAGE_ENCODERS:
            raise ValueError(f"unknown image_encoder_type: {self.image_encoder_type}")
        if self.use_images and self.image_sequence_encoder_type not in VALID_SEQUENCE_ENCODERS:
            raise ValueError(f"unknown image_sequence_encoder_type: {self.image_sequence_encoder_type}")
        if (self.use_images and self.image_encoder_type == "vit"
                and self.image_resolution % self.vit_patch_size != 0):
            raise ValueError(
                f"image_resolution {self.image_resolution} not divisible by "
                f"vit_patch_size {self.vit_patch_size} (the reshape-based "
                f"patch embed has no VALID-conv cropping)")
        if self.vit_fused_gelu not in ("exact", "poly", "quick", "bf16"):
            raise ValueError(f"unknown vit_fused_gelu: {self.vit_fused_gelu}")
        if self.vit_fused_layout not in ("stacked", "headloop"):
            raise ValueError(f"unknown vit_fused_layout: {self.vit_fused_layout}")
        for knob in ("encoder_fused_block", "encoder_fused_stack", "decoder_fused_block"):
            if getattr(self, knob) and self.attention_impl == "ring":
                raise ValueError(
                    f"{knob} runs attention inside the Pallas "
                    "program and cannot be combined with attention_impl='ring'")

    @property
    def imu_input_dim(self) -> int:
        # quaternion: 4, five_dim (axis + sin/cos): 5
        return 4 if self.imu_orientation_embedding_method == "quaternion" else 5

    @property
    def joint_names(self) -> tuple[str, ...]:
        if self.num_joints == len(CANONICAL_JOINT_NAMES_22):
            return CANONICAL_JOINT_NAMES_22
        if self.num_joints == len(CANONICAL_JOINT_NAMES_20):
            return CANONICAL_JOINT_NAMES_20
        return tuple(f"joint_{i}" for i in range(self.num_joints))


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's ``TrainConfig``)."""

    epochs: int = 10
    batch_size: int = 64
    lr: float = 1e-4
    train_denoising_timesteps: int = 1000
    num_normalization_samples: int = 1000
    distill_teacher_inference_steps: int = 30
    seed: int = 0
    weight_decay: float = 1e-2
    log_every: int = 20
    mesh_shape: dict[str, int] = field(default_factory=dict)
    flat_optimizer: bool = False
    ema_decay: float = 0.0
    dummy_task: str = "decorative"
    modality_dropout: float = 0.0
    boundary_oversample: float = 0.0
    image_encoder_lr_mult: float = 1.0
    grad_clip_norm: float = 0.0
    aux_cue_weight: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 <= self.modality_dropout < 1.0:
            raise ValueError(f"modality_dropout must be in [0, 1), got {self.modality_dropout}")
        if not 0.0 <= self.boundary_oversample < 1.0:
            raise ValueError(f"boundary_oversample must be in [0, 1), got {self.boundary_oversample}")
        if self.image_encoder_lr_mult <= 0.0:
            raise ValueError(f"image_encoder_lr_mult must be > 0, got {self.image_encoder_lr_mult}")
        if self.grad_clip_norm < 0.0:
            raise ValueError(f"grad_clip_norm must be >= 0, got {self.grad_clip_norm}")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @classmethod
    def from_dict(cls, params: dict[str, Any]) -> "Config":
        """Build from a flat hyperparameter dict; unknown keys are ignored."""
        model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
        model_kwargs = {k: v for k, v in params.items() if k in model_fields}
        train_kwargs = {k: v for k, v in params.items() if k in train_fields}
        return cls(model=ModelConfig(**model_kwargs), train=TrainConfig(**train_kwargs))

    def to_dict(self) -> dict[str, Any]:
        """The flat dict embedded in checkpoints."""
        flat = dataclasses.asdict(self.model)
        flat.update(dataclasses.asdict(self.train))
        return flat

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a setting the port does not take
    (``TypeError`` for a config that is not this package's ``ModelConfig``).

    ``attention_impl``: "xla" (``plain_attention``), "pallas" (the
    hand-written flash kernel, ``ops/flash_attention.py``), "auto" and
    "ring" (sequence parallelism over the ambient mesh's ``seq`` axis,
    ``parallel/ring_attention.py``) are accepted.
    The port's "auto" takes the flash kernel for CUDA tensors with
    Tq * Tk >= 256^2 scores per head and ``plain_attention`` otherwise (the
    JAX package's rule with the TPU read as the card), so every shipped
    shape (at most 100 x 100) stays on the plain path. The fused stacks and
    blocks ignore ``attention_impl``, as in the JAX package.

    Images: every image encoder of the JAX package: the ResNet18 / ResNet50
    encoders (``models/vision.py``, with BatchNorm running statistics), the
    Swin-T / Swin-S encoders (``models/swin.py``) and the ViT with the fused
    block on or off and every ``vit_fused_gelu`` ("exact", "quick", and
    "poly" / "bf16": the minimax polynomial of exact GELU and quick-GELU
    evaluated in bf16, both on the fused block only; the unfused layers run
    exact and quick-GELU for them, as in the JAX package).
    ``vit_fused_block_frames`` and ``vit_fused_layout`` are the TPU kernel's
    frame block and attention formulation; they are accepted and have no effect (the layouts compute
    the same function, and a CUDA grid needs no frame block).
    ``remat_image_encoder`` is False, True (every encoder) or "conv_only"
    (the ResNets only); another value raises ``ValueError``. ``aux_cue_head``
    (the training-only cue regression of ``DiffusionPolicy.forward_with_cue``)
    is accepted.

    The decoder-only tier (every context modality off) conditions the
    decoder on the diffusion step token alone.

    ``encoder_fused_stack`` and ``decoder_fused_block`` are accepted (the
    fused fwd+bwd ops of ``ops/fused_encoder_stack.py`` and
    ``ops/fused_decoder_layer.py``); their ``*_rows`` robot blocks have no
    effect. ``encoder_fused_block`` runs each layer of the three
    proprioceptive stacks as one fused ViT block (exact GELU;
    ``encoder_fused_block_rows`` has no effect); ``encoder_fused_stack``
    wins where both are set, as in the JAX package. ``ModelConfig`` itself
    raises ``ValueError`` where the JAX config does (an unknown GELU, a fused
    knob with ``attention_impl: "ring"``)."""
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"expected soccerdiffusion_tpu_torch.config.ModelConfig, got {type(cfg)}")
    if cfg.attention_impl not in ("xla", "pallas", "auto", "ring"):
        raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")
    if cfg.use_images:
        check_remat_image_encoder(cfg.remat_image_encoder, cfg.image_encoder_type)


def check_remat_image_encoder(remat: bool | str, encoder_type: str) -> None:
    """``remat_image_encoder``: False, True, or "conv_only" for the ResNets
    (it names their conv outputs; the ViT and Swin have none)."""
    if remat in (False, True):
        return
    if remat != "conv_only":
        raise ValueError(f"unknown remat_image_encoder: {remat!r} (False, True or 'conv_only')")
    if encoder_type not in ("resnet18", "resnet50"):
        raise ValueError(f"remat_image_encoder='conv_only' names the conv outputs of the ResNet "
                         f"encoders; {encoder_type!r} has none: use remat_image_encoder: true")


# most robots of one int8 chunk block: a thread-block cluster of at most 8
# blocks, each holding at most 4 of them (csrc/fused_chunk_int8.cu)
INT8_MAX_BLOCK = 32


def check_serving_supported(group_robots: int = 1, kv_quant: str = "none",
                            cross_orientation: str = "kstat",
                            block_robots: int | None = None) -> None:
    """Raise ``ValueError`` for a chunk-sampler option the JAX package
    refuses: what ``FusedChunkSampler.__init__`` checks there (an unknown
    orientation or quantisation, ``block_robots`` not a multiple of
    ``group_robots``, "qstat" with groups) and what its kernel's build
    refuses at the first sample, int8 K/V with "qstat" or with groups (here
    at once, on the configured values). (Classifier-free guidance is
    served; ``RolloutEngine`` refuses it where the JAX engine does.)"""
    if block_robots is not None and block_robots % group_robots != 0:
        raise ValueError(f"block_robots {block_robots} not divisible by group_robots "
                         f"{group_robots}")
    if cross_orientation not in ("kstat", "qstat"):
        raise ValueError(f"unknown cross_orientation {cross_orientation!r}")
    if cross_orientation == "qstat" and group_robots != 1:
        raise ValueError("cross_orientation='qstat' requires group_robots=1")
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown context_kv_quant {kv_quant!r}")
    if kv_quant == "int8" and (cross_orientation == "qstat" or group_robots != 1):
        raise ValueError("kv_quant='int8' supports the default kstat, group_robots=1 "
                         "orientation only")
