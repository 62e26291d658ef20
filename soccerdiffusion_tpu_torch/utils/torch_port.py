"""Reference (PyTorch) state dicts into the flax layout (counterpart of
``soccerdiffusion_tpu/utils/torch_port.py``, the port's own copy).

A user of the reference can load a trained ``End2EndDiffusionTransformer``
checkpoint (``{model_state_dict, hyperparams, ...}``) into the port's
``DiffusionPolicy``: these functions map its state dict onto the flax
parameter tree the JAX package would hold (plain numpy), which
``utils/jax_params.py:flax_state_dict`` lays out as the port's state dict,
the chain every JAX-side mapping of the port goes through. No function
here needs torch beyond reading tensors.

Layout conventions converted here:
  torch Linear weight (out, in)        -> flax Dense kernel (in, out)
  torch Conv1d weight (out, in, k)     -> flax Conv kernel (k, in, out)
  torch Conv2d weight (out, in, kh, kw)-> flax Conv kernel (kh, kw, in, out)
  torch MHA in_proj_weight (3E, E)     -> three (E, E) q/k/v kernels
  torch BatchNorm running stats        -> flax `batch_stats` collection

ImageNet torchvision backbones have their own loader
(``utils/torchvision_weights.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

Array = np.ndarray
Params = dict[str, Any]


def _np(x) -> Array:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def port_linear(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"kernel": _np(sd[_key(prefix, "weight")]).T, "bias": _np(sd[_key(prefix, "bias")])}


def port_layernorm(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _np(sd[_key(prefix, "weight")]), "bias": _np(sd[_key(prefix, "bias")])}


def port_conv1d(sd: Mapping[str, Any], prefix: str) -> Params:
    out = {"kernel": _np(sd[_key(prefix, "weight")]).transpose(2, 1, 0)}
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def port_conv2d(sd: Mapping[str, Any], prefix: str) -> Params:
    out = {"kernel": _np(sd[_key(prefix, "weight")]).transpose(2, 3, 1, 0)}
    if _key(prefix, "bias") in sd:
        out["bias"] = _np(sd[_key(prefix, "bias")])
    return out


def port_mha(sd: Mapping[str, Any], prefix: str) -> Params:
    """torch nn.MultiheadAttention -> MultiHeadAttention params."""
    w = _np(sd[_key(prefix, "in_proj_weight")])
    b = _np(sd[_key(prefix, "in_proj_bias")])
    e = w.shape[1]
    wq, wk, wv = w[:e], w[e : 2 * e], w[2 * e :]
    bq, bk, bv = b[:e], b[e : 2 * e], b[2 * e :]
    return {
        "q_proj": {"kernel": wq.T, "bias": bq},
        "k_proj": {"kernel": wk.T, "bias": bk},
        "v_proj": {"kernel": wv.T, "bias": bv},
        "out_proj": port_linear(sd, _key(prefix, "out_proj")),
    }


def port_batchnorm(sd: Mapping[str, Any], prefix: str) -> tuple[Params, Params]:
    """Returns (params, batch_stats) for one BatchNorm."""
    params = {"scale": _np(sd[_key(prefix, "weight")]), "bias": _np(sd[_key(prefix, "bias")])}
    stats = {"mean": _np(sd[_key(prefix, "running_mean")]), "var": _np(sd[_key(prefix, "running_var")])}
    return params, stats


def port_encoder_layer(sd: Mapping[str, Any], prefix: str) -> Params:
    """torch nn.TransformerEncoderLayer (norm_first) -> TransformerEncoderLayer."""
    return {
        "self_attn": port_mha(sd, _key(prefix, "self_attn")),
        "norm1": port_layernorm(sd, _key(prefix, "norm1")),
        "norm2": port_layernorm(sd, _key(prefix, "norm2")),
        "mlp": {
            "linear1": port_linear(sd, _key(prefix, "linear1")),
            "linear2": port_linear(sd, _key(prefix, "linear2")),
        },
    }


def port_decoder_layer(sd: Mapping[str, Any], prefix: str) -> Params:
    """torch nn.TransformerDecoderLayer (norm_first) -> TransformerDecoderLayer.

    torch names: self_attn / multihead_attn (cross), norm1/2/3, linear1/2.
    """
    return {
        "self_attn": port_mha(sd, _key(prefix, "self_attn")),
        "cross_attn": port_mha(sd, _key(prefix, "multihead_attn")),
        "norm1": port_layernorm(sd, _key(prefix, "norm1")),
        "norm2": port_layernorm(sd, _key(prefix, "norm2")),
        "norm3": port_layernorm(sd, _key(prefix, "norm3")),
        "mlp": {
            "linear1": port_linear(sd, _key(prefix, "linear1")),
            "linear2": port_linear(sd, _key(prefix, "linear2")),
        },
    }


def port_sequence_encoder(sd: Mapping[str, Any], prefix: str, num_layers: int) -> Params:
    """Reference BaseEncoder (base.py:7-53) -> SequenceEncoder params."""
    encoder_layers = {
        f"layer_{i}": port_encoder_layer(sd, _key(prefix, f"transformer_encoder.layers.{i}"))
        for i in range(num_layers)
    }
    return {
        "embedding": {"proj": port_conv1d(sd, _key(prefix, "embedding"))},
        "encoder": encoder_layers,
    }


def port_action_generator(sd: Mapping[str, Any], prefix: str, num_layers: int) -> Params:
    """Reference DiffusionActionGenerator (decoder.py:6-54) -> DiffusionActionGenerator."""
    decoder_layers = {
        f"layer_{i}": port_decoder_layer(sd, _key(prefix, f"transformer_decoder.layers.{i}"))
        for i in range(num_layers)
    }
    return {
        "embedding": port_linear(sd, _key(prefix, "embedding")),
        "decoder": decoder_layers,
        "fc_out": port_linear(sd, _key(prefix, "fc_out")),
    }


def port_resnet(sd: Mapping[str, Any], stage_sizes, bottleneck: bool,
                prefix: str = "", with_head: bool = False) -> tuple[Params, Params]:
    """torchvision ResNet state dict -> (params, batch_stats) for ResNetImageEncoder.

    ``prefix`` selects a sub-module (e.g. "encoder." for the reference's
    wrapped torchvision model). The torchvision fc head is only ported when
    ``with_head`` (the reference replaces it; reference image.py:69-83).
    """
    p = prefix
    params: Params = {"conv1": port_conv2d(sd, f"{p}conv1")}
    stats: Params = {}
    bn_params, bn_stats = port_batchnorm(sd, f"{p}bn1")
    params["bn1"], stats["bn1"] = bn_params, bn_stats

    bns = ("bn1", "bn2", "bn3") if bottleneck else ("bn1", "bn2")
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
    for stage, num_blocks in enumerate(stage_sizes):
        for i in range(num_blocks):
            tprefix = f"{p}layer{stage + 1}.{i}"
            name = f"layer{stage + 1}_{i}"
            blk_params: Params = {}
            blk_stats: Params = {}
            for conv, bn in zip(convs, bns):
                blk_params[conv] = port_conv2d(sd, f"{tprefix}.{conv}")
                bp, bs = port_batchnorm(sd, f"{tprefix}.{bn}")
                blk_params[bn], blk_stats[bn] = bp, bs
            if f"{tprefix}.downsample.0.weight" in sd:
                blk_params["downsample_conv"] = port_conv2d(sd, f"{tprefix}.downsample.0")
                bp, bs = port_batchnorm(sd, f"{tprefix}.downsample.1")
                blk_params["downsample_bn"], blk_stats["downsample_bn"] = bp, bs
            params[name], stats[name] = blk_params, blk_stats
    if with_head:
        params["fc"] = port_linear(sd, f"{p}fc")
    return params, stats


def _swin_merge_col_perm(c: int) -> np.ndarray:
    """Column permutation mapping torchvision PatchMerging's 4-patch concat
    order [x(0,0), x(1,0), x(0,1), x(1,1)] (torchvision swin v1) onto this
    repo's reshape order [x(0,0), x(0,1), x(1,0), x(1,1)]
    (models/swin.py PatchMerging). ``c`` is the per-patch channel count."""
    perm = [0, 2, 1, 3]  # ours group g reads torchvision group perm[g]
    return np.concatenate([np.arange(g * c, (g + 1) * c) for g in perm])


def port_swin(sd: Mapping[str, Any], variant: str, prefix: str = "") -> Params:
    """torchvision swin_t / swin_s state dict -> SwinImageEncoder params.

    Key layout: torchvision ``features.0`` patch embed (conv + LN),
    ``features.{1,3,5,7}`` block stages (fused qkv Linear + relative
    position bias table), ``features.{2,4,6}`` patch mergings, final
    ``norm`` + ``head`` (the reference replaces the head with a
    hidden_dim Linear, reference ml/model/encoder/image.py:86-100).
    """
    depths = (2, 2, 6, 2) if variant == "tiny" else (2, 2, 18, 2)
    k = lambda name: _key(prefix, name)
    params: Params = {
        "patch_embed": port_conv2d(sd, k("features.0.0")),
        "patch_norm": port_layernorm(sd, k("features.0.2")),
    }
    embed_dim = params["patch_embed"]["kernel"].shape[-1]
    dim = embed_dim
    for stage, depth in enumerate(depths):
        feat = 2 * stage + 1
        for i in range(depth):
            bp = k(f"features.{feat}.{i}")
            params[f"stage{stage}_block{i}"] = {
                "norm1": port_layernorm(sd, f"{bp}.norm1"),
                "attn": {
                    "qkv": port_linear(sd, f"{bp}.attn.qkv"),
                    "proj": port_linear(sd, f"{bp}.attn.proj"),
                    "relative_position_bias_table": _np(
                        sd[f"{bp}.attn.relative_position_bias_table"]),
                },
                "norm2": port_layernorm(sd, f"{bp}.norm2"),
                "mlp_fc1": port_linear(sd, f"{bp}.mlp.0"),
                "mlp_fc2": port_linear(sd, f"{bp}.mlp.3"),
            }
        if stage < len(depths) - 1:
            mp = k(f"features.{2 * stage + 2}")
            perm = _swin_merge_col_perm(dim)
            norm = port_layernorm(sd, f"{mp}.norm")
            red_kernel = _np(sd[f"{mp}.reduction.weight"]).T  # (4C, 2C)
            params[f"merge{stage}"] = {
                "norm": {"scale": norm["scale"][perm], "bias": norm["bias"][perm]},
                "reduction": {"kernel": red_kernel[perm]},
            }
            dim *= 2
    params["norm"] = port_layernorm(sd, k("norm"))
    params["head"] = port_linear(sd, k("head"))
    return params


def port_policy_state_dict(sd: Mapping[str, Any], config) -> tuple[Params, Params, Params]:
    """Full reference End2EndDiffusionTransformer state dict -> (params,
    batch_stats, norm) for DiffusionPolicy with the same hyperparams.

    ``norm`` carries the normalization buffers the reference stores on the
    model (reference model.py:119-121).
    """
    cfg = config
    params: Params = {
        "step_encoding": {"token": _np(sd["step_encoding.token"])},
        "diffusion_action_generator": port_action_generator(
            sd, "diffusion_action_generator", cfg.num_decoder_layers
        ),
    }
    stats: Params = {}
    if cfg.use_action_history:
        params["action_history_encoder"] = {
            "seq": port_sequence_encoder(sd, "action_history_encoder",
                                         cfg.num_action_history_encoder_layers)
        }
    if cfg.use_imu:
        params["imu_encoder"] = {
            "seq": port_sequence_encoder(sd, "imu_encoder", cfg.num_imu_encoder_layers)
        }
    if cfg.use_joint_states:
        params["joint_states_encoder"] = {
            "seq": port_sequence_encoder(sd, "joint_states_encoder",
                                         cfg.joint_state_encoder_layers)
        }
    if cfg.use_gamestate:
        params["game_state_encoder"] = {
            "embedding": {"embedding": _np(sd["game_state_encoder.embedding.weight"])}
        }
    if cfg.use_images:
        ise: Params = {}
        ise_stats: Params = {}
        if cfg.image_encoder_type in ("resnet18", "resnet50"):
            # With a transformer sequence encoder the frame encoder sits at
            # `.image_encoder` (reference image.py:110); with "none" the frame
            # encoder IS the sequence encoder attribute (reference image.py:172).
            if cfg.image_sequence_encoder_type == "transformer":
                enc_prefix = "image_sequence_encoder.image_encoder.encoder."
            else:
                enc_prefix = "image_sequence_encoder.encoder."
            stage_sizes = (2, 2, 2, 2) if cfg.image_encoder_type == "resnet18" else (3, 4, 6, 3)
            enc_params, enc_stats = port_resnet(
                sd, stage_sizes, bottleneck=cfg.image_encoder_type == "resnet50",
                prefix=enc_prefix,
            )
            enc_params["fc"] = port_linear(sd, f"{enc_prefix}fc")
            if not cfg.image_use_final_avgpool:
                # avgpool was replaced by a 1x1 conv (reference image.py:81-83)
                enc_params["spatial_head_conv"] = port_conv2d(sd, f"{enc_prefix}avgpool")
            ise["image_encoder"] = enc_params
            ise_stats["image_encoder"] = enc_stats
        elif cfg.image_encoder_type in ("swin_transformer_tiny",
                                        "swin_transformer_small"):
            if cfg.image_sequence_encoder_type == "transformer":
                enc_prefix = "image_sequence_encoder.image_encoder.encoder"
            else:
                enc_prefix = "image_sequence_encoder.encoder"
            variant = ("tiny" if cfg.image_encoder_type.endswith("tiny")
                       else "small")
            ise["image_encoder"] = port_swin(sd, variant, prefix=enc_prefix)
        else:
            raise NotImplementedError(
                f"porting {cfg.image_encoder_type} from reference checkpoints is not supported"
            )
        if cfg.image_sequence_encoder_type == "transformer":
            # reference TransformerImageSequenceEncoder wraps a BaseEncoder
            # named `transformer_encoder` with patch size 1 and 8 heads
            # (reference image.py:111-118).
            ise["seq"] = port_sequence_encoder(
                sd, "image_sequence_encoder.transformer_encoder",
                cfg.num_image_sequence_encoder_layers,
            )
        params["image_sequence_encoder"] = ise
        stats["image_sequence_encoder"] = ise_stats
    norm = {"mean": _np(sd["mean"]), "std": _np(sd["std"])}
    return params, stats, norm
