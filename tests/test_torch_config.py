"""The port's own configuration (soccerdiffusion_tpu_torch/config.py) against
the JAX package's: the same fields and defaults, the same checks, the same
flat-dict / YAML round trip for every shipped config; what check_supported
accepts; and chip_smoke.py's flagship config against vit_flagship.yaml."""

import dataclasses
from pathlib import Path

import pytest

from soccerdiffusion_tpu import config as jax_config
from soccerdiffusion_tpu_torch import config as port

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted((REPO / "soccerdiffusion_tpu" / "training" / "configs").glob("*.yaml")) + sorted(
    (REPO / "soccerdiffusion_tpu_torch" / "training" / "configs").glob("*.yaml"))
FLAGSHIP = REPO / "soccerdiffusion_tpu" / "training" / "configs" / "vit_flagship.yaml"


def defaults(cls):
    return {f.name: (f.default_factory() if f.default_factory is not dataclasses.MISSING
                     else f.default) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "Config"])
def test_fields_and_defaults_match(name):
    ours, theirs = getattr(port, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    if name != "Config":
        assert defaults(ours) == defaults(theirs)
    assert ours.__dataclass_params__.frozen


@pytest.mark.parametrize("cls,kw", [
    ("ModelConfig", dict(imu_orientation_embedding_method="euler")),
    ("ModelConfig", dict(image_encoder_type="vgg")),
    ("ModelConfig", dict(image_sequence_encoder_type="lstm")),
    ("ModelConfig", dict(image_encoder_type="vit", image_resolution=100, vit_patch_size=16)),
    ("ModelConfig", dict(vit_fused_gelu="tanh")),
    ("ModelConfig", dict(vit_fused_layout="flat")),
    ("ModelConfig", dict(encoder_fused_block=True, attention_impl="ring")),
    ("ModelConfig", dict(encoder_fused_stack=True, attention_impl="ring")),
    ("ModelConfig", dict(decoder_fused_block=True, attention_impl="ring")),
    ("TrainConfig", dict(modality_dropout=1.0)),
    ("TrainConfig", dict(boundary_oversample=-0.1)),
    ("TrainConfig", dict(image_encoder_lr_mult=0.0)),
    ("TrainConfig", dict(grad_clip_norm=-1.0)),
])
def test_post_init_errors_match(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jax_config, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(port, cls)(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path", YAMLS, ids=[p.name for p in YAMLS])
def test_yaml_round_trips_like_jax(path):
    ours, theirs = port.Config.from_yaml(str(path)), jax_config.Config.from_yaml(str(path))
    assert ours.to_dict() == theirs.to_dict()
    assert port.Config.from_dict(ours.to_dict()) == ours
    m, jm = ours.model, theirs.model
    assert (m.imu_input_dim, m.joint_names) == (jm.imu_input_dim, jm.joint_names)


def test_check_supported_takes_the_flagship_and_rejects_resnet():
    """Every shipped YAML is accepted (the ResNet ones since the ResNet / Swin
    slice); what still raises: aux_cue_head, encoder_fused_block, "ring"
    and the unported GELUs (NotImplementedError), and remat_image_encoder
    "conv_only" on a ViT or Swin or any other string (ValueError)."""
    port.check_supported(port.Config.from_yaml(str(FLAGSHIP)).model)
    resnet = port.Config.from_yaml(str(FLAGSHIP.with_name("default.yaml"))).model
    port.check_supported(resnet)
    port.check_supported(dataclasses.replace(resnet, remat_image_encoder="conv_only"))
    flagship = port.Config.from_yaml(str(FLAGSHIP)).model
    for kw in (dict(vit_fused_gelu="poly"), dict(vit_fused_gelu="bf16"),
               dict(aux_cue_head=True), dict(encoder_fused_block=True),
               dict(attention_impl="ring", encoder_fused_stack=False,
                    decoder_fused_block=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.check_supported(dataclasses.replace(flagship, **kw))
    for cfg, remat in ((flagship, "conv_only"),
                       (dataclasses.replace(resnet, image_encoder_type="swin_transformer_tiny"),
                        "conv_only"), (resnet, "everything")):
        with pytest.raises(ValueError, match="remat_image_encoder"):
            port.check_supported(dataclasses.replace(cfg, remat_image_encoder=remat))
    for kw in (dict(remat_image_encoder=True),
               dict(use_action_history=False, use_imu=False, use_joint_states=False,
                    use_images=False, use_gamestate=False)):
        port.check_supported(dataclasses.replace(flagship, **kw))
    port.check_supported(dataclasses.replace(flagship, vit_fused_layout="headloop",
                                             vit_fused_block=False, vit_fused_gelu="exact"))


def test_chip_smoke_flagship_config_is_the_yaml():
    import chip_smoke

    assert chip_smoke.flagship_config() == port.Config.from_yaml(str(FLAGSHIP)).model
