"""The port's image encoders (models/vision.py) against flax, through
load_jax_params: the ViT image encoder (fused block and plain layers, exact
and quick GELU) and the image sequence encoder in its three modes, float32.
The JAX fused blocks and stacks run their Pallas kernels in interpret mode;
the port's run the kernels' plain versions (CPU tensors). Inputs from numpy
with a seed, NHWC frames. Tolerance 2e-5 absolute: float32 summation order
through 2 blocks at unit-scale activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccerdiffusion_tpu.models.vision import ImageSequenceEncoder as JaxSeqEncoder
from soccerdiffusion_tpu.models.vision import ViTImageEncoder as JaxViT
from soccerdiffusion_tpu_torch.models.vision import (
    ImageSequenceEncoder,
    ViTImageEncoder,
    make_image_encoder,
)
from soccerdiffusion_tpu_torch.ops import fused_encoder_stack, fused_vit_block
from soccerdiffusion_tpu_torch.utils.jax_params import load_jax_params

HIDDEN, RES, PATCH, WIDTH, DEPTH, FRAMES = 48, 32, 8, 64, 2, 4
ATOL = 2e-5


def noisy(params, rng):
    """flax params with nonzero biases and LayerNorm offsets."""
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def frames(rng, *lead):
    return rng.standard_normal((*lead, RES, RES, 3)).astype(np.float32)


@pytest.mark.parametrize("gelu", ["exact", "quick"])
@pytest.mark.parametrize("fused", [True, False])
def test_vit_encoder_matches_flax(fused, gelu):
    rng = np.random.default_rng(0)
    x = frames(rng, 3)
    jvit = JaxViT(HIDDEN, patch_size=PATCH, width=WIDTH, depth=DEPTH, fused_block=fused,
                  fused_gelu=gelu)
    params = noisy(jvit.init(jax.random.key(0), jnp.asarray(x), False)["params"], rng)
    ref = np.asarray(jvit.apply({"params": params}, jnp.asarray(x), False))
    vit = load_jax_params(ViTImageEncoder(HIDDEN, RES, PATCH, WIDTH, DEPTH, fused_block=fused,
                                          fused_gelu=gelu), params)
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
        pre = vit(vit.patchify(torch.from_numpy(x)))  # pre-patchified (N, patches, P*P*C)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(pre, got, atol=0, rtol=0)


def seq_pair(seq_type, fused, rng):
    kw = dict(hidden_dim=HIDDEN, encoder_type="vit", sequence_encoder_type=seq_type, num_layers=1,
              max_seq_len=FRAMES)
    jenc = JaxSeqEncoder(**kw, vit_geometry=(PATCH, WIDTH, DEPTH), vit_fused_block=fused,
                         vit_fused_gelu="quick", seq_fused_stack=fused)
    x = frames(rng, 2, FRAMES)
    params = noisy(jenc.init(jax.random.key(1), jnp.asarray(x), False)["params"], rng)
    enc = ImageSequenceEncoder(HIDDEN, "vit", seq_type, 1, FRAMES, RES, (PATCH, WIDTH, DEPTH),
                               vit_fused_block=fused, vit_fused_gelu="quick",
                               seq_fused_stack=fused)
    return jenc, params, load_jax_params(enc, params), x


@pytest.mark.parametrize("seq_type,fused", [("transformer", True), ("transformer", False),
                                            ("none", True)])
def test_sequence_encoder_modes_match_flax(seq_type, fused):
    rng = np.random.default_rng(2)
    jenc, params, enc, x = seq_pair(seq_type, fused, rng)
    tokens = rng.standard_normal((2, FRAMES, HIDDEN)).astype(np.float32)
    apply = lambda a, mode: np.asarray(jenc.apply({"params": params}, jnp.asarray(a), False,
                                                  mode=mode))
    launches = fused_vit_block.forward_kernel.launches, fused_encoder_stack.FusedEncoderStack.fwd_launches
    with torch.no_grad():
        for a, mode in ((x, "full"), (x, "frames"), (tokens, "sequence")):
            got = enc(torch.from_numpy(a), mode=mode).numpy()
            np.testing.assert_allclose(got, apply(a, mode), atol=ATOL, rtol=0, err_msg=mode)
    assert launches == (fused_vit_block.forward_kernel.launches,
                        fused_encoder_stack.FusedEncoderStack.fwd_launches)


def test_frames_then_sequence_equals_full():
    _, _, enc, x = seq_pair("transformer", True, np.random.default_rng(3))
    with torch.no_grad():
        full = enc(torch.from_numpy(x))
        split = enc(enc(torch.from_numpy(x), mode="frames"), mode="sequence")
    torch.testing.assert_close(split, full, atol=0, rtol=0)


def test_unported_inputs_raise():
    """An unknown mode or encoder type raises ValueError, and so do
    pre-patchified frames for a non-ViT encoder; the four non-ViT types
    build (the ResNets and Swin are ported)."""
    _, _, enc, x = seq_pair("none", False, np.random.default_rng(4))
    with pytest.raises(ValueError, match="unknown mode"):
        enc(torch.from_numpy(x), mode="tokens")
    with pytest.raises(ValueError, match="unknown image encoder type"):
        make_image_encoder("vgg16", HIDDEN, RES)
    built = {kind: make_image_encoder(kind, HIDDEN, 224 if kind.startswith("swin") else RES)
             for kind in ("resnet18", "resnet50", "swin_transformer_tiny",
                          "swin_transformer_small")}
    assert [type(e).__name__ for e in built.values()] == ["ResNetImageEncoder"] * 2 + [
        "SwinImageEncoder"] * 2
    resnet = ImageSequenceEncoder(HIDDEN, "resnet18", "none", 1, FRAMES, RES)
    with pytest.raises(ValueError, match="ViT-only"):
        resnet(torch.zeros((1, FRAMES, 16, PATCH * PATCH * 3), dtype=torch.uint8),
               valid=torch.ones((1, FRAMES)))
