"""The reference's (PyTorch) checkpoints imported by the port
(``utils/torch_port.py``, ``utils/import_torch_checkpoint.py``) against the
JAX package's import of the same files, float32 on the CPU:

  * ``tests/torch_reference_policy.py`` (the JAX-free replica the port's
    tests and ``chip_smoke.py`` use) holds the same state-dict keys,
    values and outputs as ``tests/test_policy.py``'s replica under the
    same seed;
  * ``port_policy_state_dict`` equal, leaf for leaf and bit for bit, to the
    JAX function's on reference-layout state dicts: the proprioceptive
    replica's, and ResNet18, ResNet50 and Swin-T image encoders
    (torchvision layouts synthesised as tests/test_import_torch_checkpoint.py
    and tests/test_swin_port.py make them) under the reference's
    ``image_sequence_encoder`` prefixes;
  * a ``.pth``, standard and legacy ``ema_model.*`` with ``--hyperparams``,
    through the port's importer: the reference model's own denoiser output
    within 1e-5 of its scale (the JAX import's test holds 5e-4 relative),
    the chunks the JAX package serves from its import of the same file
    within 1e-5 of their scale, and the JAX importer's msgpack output
    loading in the port to the same tensors bit for bit;
  * the importer's refusals (no hyperparameters, no EMA keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from soccerdiffusion_tpu.config import Config as JaxConfig
from soccerdiffusion_tpu.config import ModelConfig
from soccerdiffusion_tpu.diffusion import make_schedule as jax_make_schedule
from soccerdiffusion_tpu.inference.sampler import make_chunk_sampler as jax_make_chunk_sampler
from soccerdiffusion_tpu.training.checkpoint import load_policy_checkpoint as jax_load_policy
from soccerdiffusion_tpu.utils import import_torch_checkpoint as jax_import
from soccerdiffusion_tpu.utils import torch_port as jax_torch_port
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.inference.sampler import make_chunk_sampler
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint, load_policy
from soccerdiffusion_tpu_torch.utils import import_torch_checkpoint, torch_port
from soccerdiffusion_tpu_torch.utils.jax_params import _flatten
from tests import test_policy
from tests.test_import_torch_checkpoint import make_torchvision_resnet18_sd
from tests.test_swin_port import synth_swin_sd
from tests.test_torch_evaluation import JitPolicy
from tests.test_torch_jax_params import make_batch, port_config, to_jax, to_torch
from tests.torch_reference_policy import TorchBaseEncoder, TorchReferencePolicy, reference_state_dict

PROPRIO = ModelConfig(**test_policy.PROPRIO)
B, STEPS = 3, 3
REF_TOL = SERVE_TOL = 1e-5


def replica(cfg, seed):
    torch.manual_seed(seed)
    return TorchReferencePolicy(port_config(cfg)).eval()


def torch_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = make_batch(cfg, B, rng)
    noisy = rng.standard_normal((B, cfg.trajectory_prediction_length, cfg.num_joints))
    steps = rng.integers(0, 1000, (B,))
    tbatch = {k: torch.from_numpy(v).long() if k == "game_state" else torch.from_numpy(v)
              for k, v in batch.items()}
    return batch, tbatch, torch.from_numpy(noisy.astype(np.float32)), torch.from_numpy(steps)


def test_replica_equals_test_policy_replica():
    ours = replica(PROPRIO, 7)
    torch.manual_seed(7)
    theirs = test_policy.TorchReferencePolicy(PROPRIO).eval()
    sd, want = ours.state_dict(), theirs.state_dict()
    assert list(sd) == list(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    _, tbatch, noisy, steps = torch_inputs(PROPRIO, 1)
    with torch.no_grad():
        assert torch.equal(ours(tbatch, noisy, steps), theirs(tbatch, noisy, steps))


# --------------------------------------------- reference-layout state dicts

def _bottleneck_resnet_sd(seed=4):
    """A ResNet50 state dict in torchvision's layout (bottleneck blocks)."""
    rng = np.random.default_rng(seed)
    sd = {}
    conv = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{leaf}"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))

    sd["conv1.weight"] = conv(64, 3, 7, 7)
    bn("bn1", 64)
    in_c = 64
    for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for i in range(blocks):
            p = f"layer{stage + 1}.{i}"
            sd[f"{p}.conv1.weight"] = conv(width, in_c if i == 0 else 4 * width, 1, 1)
            bn(f"{p}.bn1", width)
            sd[f"{p}.conv2.weight"] = conv(width, width, 3, 3)
            bn(f"{p}.bn2", width)
            sd[f"{p}.conv3.weight"] = conv(4 * width, width, 1, 1)
            bn(f"{p}.bn3", 4 * width)
            if i == 0:
                sd[f"{p}.downsample.0.weight"] = conv(4 * width, in_c, 1, 1)
                bn(f"{p}.downsample.1", 4 * width)
        in_c = 4 * width
    return sd


def image_state_dict(encoder: str):
    """(config, reference-layout state dict): the proprioceptive replica's
    weights plus a ``encoder`` frame encoder behind the reference's
    transformer image sequence encoder."""
    cfg = dataclasses.replace(PROPRIO, use_images=True, image_encoder_type=encoder,
                              image_sequence_encoder_type="transformer",
                              num_image_sequence_encoder_layers=1, image_context_length=2,
                              image_use_final_avgpool=False)
    sd = reference_state_dict(replica(PROPRIO, 8))
    h = cfg.hidden_dim
    if encoder == "swin_transformer_tiny":
        sd.update(synth_swin_sd("tiny", h, prefix="image_sequence_encoder.image_encoder.encoder"))
    else:
        enc = make_torchvision_resnet18_sd() if encoder == "resnet18" else _bottleneck_resnet_sd()
        enc = {k: v for k, v in enc.items() if not k.startswith("fc.")}
        feat = 512 if encoder == "resnet18" else 2048
        enc["fc.weight"], enc["fc.bias"] = torch.randn(h, feat), torch.randn(h)
        enc["avgpool.weight"], enc["avgpool.bias"] = torch.randn(1, feat, 1, 1), torch.randn(1)
        sd.update({f"image_sequence_encoder.image_encoder.encoder.{k}": v for k, v in enc.items()})
    torch.manual_seed(9)
    seq = TorchBaseEncoder(h, 1, h, 1, 8, cfg.image_context_length)
    sd.update({f"image_sequence_encoder.transformer_encoder.{k}": v
               for k, v in seq.state_dict().items()})
    return cfg, sd


def proprio_state_dict():
    return PROPRIO, reference_state_dict(replica(PROPRIO, 8))


STATE_DICTS = {"proprio": proprio_state_dict, "resnet18": lambda: image_state_dict("resnet18"),
               "resnet50": lambda: image_state_dict("resnet50"),
               "swin_t": lambda: image_state_dict("swin_transformer_tiny")}


@pytest.mark.parametrize("name", list(STATE_DICTS))
def test_port_policy_state_dict_equals_the_jax_mapping(name):
    cfg, sd = STATE_DICTS[name]()
    got = torch_port.port_policy_state_dict(sd, port_config(cfg))
    want = jax_torch_port.port_policy_state_dict(sd, cfg)
    for ours, theirs in zip(got, want):
        ours, theirs = _flatten(ours), _flatten(theirs)
        assert list(ours) == list(theirs)
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    assert _flatten(got[0]) and _flatten(got[2])
    if name != "proprio":
        assert _flatten(got[0]["image_sequence_encoder"]["image_encoder"])
    assert bool(_flatten(got[1])) == name.startswith("resnet")


# ------------------------------------------------------------------ import

def write_pth(tmp_path, legacy: bool):
    tmodel = replica(PROPRIO, 11)
    sd = reference_state_dict(tmodel)
    sd["mean"], sd["std"] = torch.linspace(2.0, 4.0, 6), torch.linspace(0.5, 1.5, 6)
    hp = {**test_policy.PROPRIO, "distill_teacher_inference_steps": STEPS}
    if legacy:
        raw = {f"ema_model.{k}": v for k, v in sd.items()}
        raw.update({"online_model.x": torch.zeros(1), "ema_model.initted": torch.tensor(True),
                    "ema_model.step": torch.tensor(100)})
        path = tmp_path / "legacy_ema.pth"
        torch.save(raw, path)
        (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(hp))
        extra = ["--hyperparams", str(tmp_path / "cfg.yaml")]
    else:
        path = tmp_path / "ref.pth"
        torch.save({"model_state_dict": sd, "hyperparams": hp, "current_epoch": 4}, path)
        extra = []
    return path, extra, tmodel


@pytest.mark.parametrize("legacy", [False, True], ids=["standard", "legacy_ema"])
def test_import_serves_like_the_jax_import(tmp_path, legacy):
    path, extra, tmodel = write_pth(tmp_path, legacy)
    import_torch_checkpoint.main([str(path), "-o", str(tmp_path / "port"), *extra])
    jax_import.main([str(path), "-o", str(tmp_path / "jax"), *extra])
    ours, theirs = load_checkpoint(tmp_path / "port"), load_checkpoint(tmp_path / "jax")
    assert (ours["format"], theirs["format"]) == ("soccerdiffusion_tpu_torch/1",
                                                  "soccerdiffusion_tpu/msgpack")
    assert ours["current_epoch"] == theirs["current_epoch"] == (0 if legacy else 4)
    assert ours["step"] == theirs["step"] == 0 and not ours["optimizer"] and not ours["ema"]
    assert list(ours["params"]) == list(theirs["params"])
    assert all(torch.equal(ours["params"][k], theirs["params"][k]) for k in theirs["params"])
    assert torch.equal(ours["norm"].mean, theirs["norm"].mean)

    # the reference model's own denoiser output
    model, norm, steps, distilled, _ = load_policy(tmp_path / "port", "cpu")
    batch, tbatch, noisy, t = torch_inputs(PROPRIO, 2)
    with torch.no_grad():
        want = tmodel(tbatch, noisy, t)
        got = model(to_torch(batch), noisy, t)
    assert torch.allclose(got, want, rtol=0, atol=REF_TOL * want.abs().max().item())

    # the chunks the JAX package serves from its own import
    hp, variables, jnorm, jsteps, jdistilled = jax_load_policy(tmp_path / "jax")
    assert (steps, distilled) == (jsteps, jdistilled) == (STEPS, False)
    rng = jax.random.key(4)
    jcfg = JaxConfig.from_dict(hp).model
    chunks = jax_make_chunk_sampler(JitPolicy(jcfg), jax_make_schedule(1000), jnorm, jsteps,
                                    jit=False)(variables, to_jax(batch), rng)
    noise = np.asarray(jax.random.normal(rng, (B, jcfg.trajectory_prediction_length,
                                               jcfg.num_joints), dtype=jnp.float32))
    served = make_chunk_sampler(model, make_schedule(1000), norm, steps)(
        to_torch(batch), torch.from_numpy(noise.copy()))
    chunks = np.asarray(chunks)
    np.testing.assert_allclose(served.numpy(), chunks,
                               atol=SERVE_TOL * max(1.0, np.abs(chunks).max()), rtol=0)


def test_importer_refusals():
    with pytest.raises(ValueError, match="not an EMA checkpoint"):
        import_torch_checkpoint.extract_ema_state_dict({"foo": torch.zeros(1)})
    with pytest.raises(ValueError, match="hyperparams"):
        import_torch_checkpoint.convert({"some_weight": torch.zeros(1)})
