"""The ResNet image configurations on the CPU against the JAX package:
default.yaml's architecture cut to a small size (hidden 64, 6 joints,
12-step contexts, 1-layer stacks, 2 decoder layers, 4 frames of 64 px,
ResNet18 with the spatial head) and sim_scratch.yaml's five-dim IMU, patch
5 and no joint states or game state: encode_context and the forward (eval
mode, float32). Every YAML copy of the port equals the JAX YAML it mirrors,
and each builds and takes the JAX variables of its configuration;
load_imagenet_backbone against the JAX package's, and through train.py;
BatchNorm statistics through the port's checkpoint. Serving and training
of these configurations: tests/test_torch_image_serving.py and
tests/test_torch_image_training.py, which share this file's
configurations and helpers.

Tolerance: context and forward 1e-4 of their scale (float32 summation
order through the ResNet and a few transformer layers).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu import config as jax_config
from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.data.dataset import WindowedDataset as JaxWindowed
from soccerdiffusion_tpu.data.dummy import generate_dummy_arrays as jax_dummy
from soccerdiffusion_tpu.data.packed import PackedDataset as JaxPacked
from soccerdiffusion_tpu.models import DiffusionPolicy as JaxPolicy
from soccerdiffusion_tpu.models.vision import ResNetImageEncoder as JaxResNet
from soccerdiffusion_tpu.utils import torch_port
from soccerdiffusion_tpu_torch import config as port
from soccerdiffusion_tpu_torch.data import Normalizer, WindowedDataset, generate_dummy_arrays
from soccerdiffusion_tpu_torch.data.packed import PackedDataset
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.models.layers import BatchNorm
from soccerdiffusion_tpu_torch.models.vision import make_image_encoder
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from soccerdiffusion_tpu_torch.training.trainer import create_train_state, make_optimizer
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten, load_jax_params, random_jax_params
from soccerdiffusion_tpu_torch.utils.torchvision_weights import load_imagenet_backbone
from tests.test_torch_jax_params import SMALL, build_pair, port_config, to_jax, to_torch

REPO = Path(__file__).resolve().parent.parent
JAX_YAMLS = REPO / "soccerdiffusion_tpu" / "training" / "configs"
PORT_YAMLS = REPO / "soccerdiffusion_tpu_torch" / "training" / "configs"
MIRRORED = sorted(p.name for p in PORT_YAMLS.glob("*.yaml") if (JAX_YAMLS / p.name).exists())

B, STEPS, CTX_TOL = 2, 3, 1e-4
# default.yaml's architecture, cut to size
DEFAULT = ModelConfig(**{**SMALL.__dict__, "trajectory_prediction_length": 10,
                         "use_images": True, "image_encoder_type": "resnet18",
                         "image_resolution": 64, "image_context_length": 4,
                         "image_use_final_avgpool": False})
# sim_scratch.yaml's: five-dim IMU, patch 5, no joint states or game state
SIM = ModelConfig(**{**DEFAULT.__dict__, "imu_orientation_embedding_method": "five_dim",
                     "encoder_patch_size": 5, "action_context_length": 10,
                     "imu_context_length": 10, "joint_state_context_length": 10,
                     "use_joint_states": False, "use_gamestate": False})
CONFIGS = {"default": DEFAULT, "sim_scratch": SIM}


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1e-30), rtol=0,
                               err_msg=what)


# ------------------------------------------------------------ the YAMLs

@pytest.mark.parametrize("name", MIRRORED)
def test_port_yaml_equals_the_jax_yaml(name):
    ours = port.Config.from_yaml(str(PORT_YAMLS / name))
    theirs = jax_config.Config.from_yaml(str(JAX_YAMLS / name))
    assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("name", MIRRORED)
def test_every_yaml_builds_and_takes_the_jax_variables(name):
    """The port's DiffusionPolicy of each YAML copy takes the params and
    batch_stats of the JAX model of the same YAML (shapes from
    jax.eval_shape of its init), every leaf used once."""
    cfg = port.Config.from_yaml(str(PORT_YAMLS / name)).model
    jcfg = jax_config.Config.from_yaml(str(JAX_YAMLS / name)).model
    b = 1
    batch = {"joint_command_history": jnp.zeros((b, jcfg.action_context_length, jcfg.num_joints)),
             "rotation": jnp.zeros((b, jcfg.imu_context_length, jcfg.imu_input_dim)),
             "joint_state": jnp.zeros((b, jcfg.joint_state_context_length, jcfg.num_joints)),
             "game_state": jnp.zeros((b,), jnp.int32),
             "joint_command": jnp.zeros((b, jcfg.trajectory_prediction_length, jcfg.num_joints))}
    if jcfg.use_images:
        res = jcfg.image_resolution
        batch["image_data"] = jnp.zeros((b, jcfg.image_context_length, res, res, 3))
    shapes = jax.eval_shape(JaxPolicy(jcfg).init, jax.random.key(0), batch,
                            batch["joint_command"], jnp.zeros((b,), jnp.int32))
    rng = np.random.default_rng(0)
    draw = lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
    params = jax.tree.map(draw, shapes["params"])
    stats = jax.tree.map(draw, shapes.get("batch_stats", {}))
    model = load_jax_params(DiffusionPolicy(cfg), params, stats)
    assert len(_flatten(params)) == sum(1 for _ in model.parameters())
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert len(_flatten(stats)) == 2 * n_bn
    assert n_bn == (0 if not cfg.use_images else {"resnet18": 20, "vit": 0}[
        cfg.image_encoder_type])


# ------------------------------------------------------- forward, serving

@pytest.mark.parametrize("name", CONFIGS)
def test_context_and_forward_match_jax(name):
    cfg = CONFIGS[name]
    jmodel, variables, model, batch, rng = build_pair(cfg, b=3)
    noisy = rng.standard_normal((3, cfg.trajectory_prediction_length,
                                 cfg.num_joints)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    ref_ctx = jmodel.apply(variables, to_jax(batch), False, method=jmodel.encode_context)
    ref = jmodel.apply(variables, to_jax(batch), jnp.asarray(noisy), jnp.asarray(t), False)
    model.eval()
    with torch.no_grad():
        ctx = model.encode_context(to_torch(batch))
        got = model(to_torch(batch), torch.from_numpy(noisy), torch.from_numpy(t))
    close(ctx.numpy(), ref_ctx, CTX_TOL, "context")
    close(got.numpy(), ref, CTX_TOL, "eps")


# --------------------------------------------- backbone weights, checkpoint

def packed_batches(cfg, steps=STEPS, b=B):
    """The first shuffled packed batches (whole uint8 frames) of the
    "vision" dummy task for ``cfg``, from the JAX package and the port, the
    frames' pixels replaced by the same seeded uint8 noise in both: the
    task's frames hold 4 distinct pixel values, so the ResNet's max pool
    meets ties between equal patches that float32 rounding breaks either
    way (a choice of subgradient, not a difference of function)."""
    kw = dict(num_recordings=2, num_samples=40, num_joints=cfg.num_joints,
              image_size=cfg.image_resolution, seed=2, task="vision", with_images=cfg.use_images)
    jp = JaxPacked.from_windowed(JaxWindowed.from_dummy(jax_dummy(**kw), cfg))
    pp = PackedDataset.from_windowed(WindowedDataset.from_dummy(generate_dummy_arrays(**kw),
                                                                port_config(cfg)))
    out = [list(ds.batches(b, seed=1))[:steps] for ds in (jp, pp)]
    rng = np.random.default_rng(3)
    for jb, pb in zip(*out):
        if "image_u8" in jb:
            jb["image_u8"] = pb["image_u8"] = rng.integers(0, 256, jb["image_u8"].shape,
                                                           dtype=np.uint8)
    return out



def torchvision_name(key: str) -> str:
    """The torchvision ResNet key of a port backbone key."""
    module, leaf = key.rsplit(".", 1)
    module = module.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                       "downsample.1")
    for stage in range(1, 5):
        module = module.replace(f"layer{stage}_", f"layer{stage}.")
    leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    return f"{module}.{leaf}"


@pytest.mark.parametrize("kind", ["resnet18", "resnet50"])
def test_imagenet_backbone_matches_the_jax_loader(kind, tmp_path):
    """A seeded torchvision-named state dict (torch.save'd), through the JAX
    package's utils/torch_port.load_imagenet_backbone and the port's: the
    same eval-mode encoder output; fc and the spatial head keep their init."""
    res, hidden = 64, 16
    enc = make_image_encoder(kind, hidden, res, use_final_avgpool=False)
    params, stats = random_jax_params(enc, seed=1)
    load_jax_params(enc, params, stats)
    rng = np.random.default_rng(2)
    sd = {}
    for key, value in enc.state_dict().items():
        if key.startswith(("fc.", "spatial_head_conv.")):
            continue
        arr = rng.normal(size=tuple(value.shape)) / np.sqrt(max(1, value[0].numel()))
        if key.endswith(".var"):
            arr = rng.uniform(0.5, 1.5, tuple(value.shape))
        sd[torchvision_name(key)] = torch.from_numpy(arr.astype(np.float32))
        if key.endswith(".var"):
            sd[torchvision_name(key).replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512 * (4 if kind == "resnet50" else 1)), \
        torch.zeros(1000)
    path = tmp_path / f"{kind}.pth"
    torch.save(sd, path)
    jp, js = torch_port.load_imagenet_backbone(ModelConfig(image_encoder_type=kind), str(path))
    jparams = {**params, **jax.tree.map(np.asarray, jp)}
    jstats = {**stats, **jax.tree.map(np.asarray, js)}
    stages, bottleneck = ((2, 2, 2, 2), False) if kind == "resnet18" else ((3, 4, 6, 3), True)
    x = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    ref = jax.jit(lambda v, xx: JaxResNet(hidden, stages, bottleneck, use_final_avgpool=False)
                  .apply(v, xx, False))({"params": jparams, "batch_stats": jstats},
                                        jnp.asarray(x))
    fc = enc.fc.weight.detach().clone()
    load_imagenet_backbone(enc, path)
    enc.eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    close(got.numpy(), ref, CTX_TOL)
    torch.testing.assert_close(enc.fc.weight, fc, atol=0, rtol=0)
    with pytest.raises(ValueError, match="local file"):
        load_imagenet_backbone(enc, "auto")


def test_batchnorm_statistics_round_trip_through_the_checkpoint(tmp_path):
    model = DiffusionPolicy(port_config(DEFAULT))
    load_jax_params(model, *random_jax_params(model, seed=4))
    state = create_train_state(model, make_optimizer(model, 1e-3, 10))
    save_checkpoint(tmp_path / "ckpt", state, Normalizer.identity(6),
                    port_config(DEFAULT).__dict__, epoch=0)
    fresh = DiffusionPolicy(port_config(DEFAULT))
    fresh_state = create_train_state(fresh, make_optimizer(fresh, 1e-3, 10))
    load_checkpoint(tmp_path / "ckpt", fresh_state)
    bns = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 20
    got = dict(fresh.named_modules())
    for name, bn in bns:
        for leaf in ("mean", "var"):
            torch.testing.assert_close(getattr(got[name], leaf), getattr(bn, leaf), atol=0,
                                       rtol=0)
    assert not torch.equal(got[bns[0][0]].var, torch.ones_like(bns[0][1].var))


def test_pretrained_weights_go_through_train(tmp_path):
    """train.py's --pretrained-weights reads the backbone; without it a ResNet
    config trains from its random init."""
    from soccerdiffusion_tpu_torch.training import train

    cfg = port.Config(model=port_config(DEFAULT), train=port.TrainConfig(
        batch_size=B, num_normalization_samples=20, log_every=1))
    enc = make_image_encoder("resnet18", 64, 64, use_final_avgpool=False)
    sd = {torchvision_name(k): torch.full_like(v, 0.01) for k, v in enc.state_dict().items()
          if not k.startswith(("fc.", "spatial_head_conv."))}
    torch.save(sd, tmp_path / "r18.pth")
    state = train.train(cfg, train.RunOptions(output=str(tmp_path / "ckpt"), packed=True, epochs=1,
                                              steps_per_epoch=1, device="cpu",
                                              pretrained_weights=str(tmp_path / "r18.pth")))
    assert state.step == 1
    conv1 = state.model.image_sequence_encoder.image_encoder.conv1.weight
    assert abs(conv1.mean().item() - 0.01) < 1e-3  # one AdamW step of lr ~4e-6 from 0.01
