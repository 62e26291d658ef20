"""Import a reference (PyTorch) checkpoint into the port's checkpoint format
(counterpart of ``soccerdiffusion_tpu/utils/import_torch_checkpoint.py``,
which writes the JAX package's format).

Covers both checkpoint generations of the reference:

  * standard checkpoints ``{model_state_dict, hyperparams, ...}``
  * legacy EMA checkpoints wrapped by ``ema_pytorch.EMA``, whose weights
    live under ``ema_model.*``: detected, and the EMA weights imported as
    the model's, with ``--hyperparams config.yaml`` supplying the
    architecture where the checkpoint embeds none

The state dict goes through ``utils/torch_port.py:port_policy_state_dict``
(the flax layout) and ``utils/jax_params.py:flax_state_dict`` (the port's
names) into a ``state.pt`` checkpoint with step 0 and no optimizer state
(a resume from it starts fresh AdamW moments). The ``.pth`` is read with
``torch.load(weights_only=True)``: tensors and plain containers only.

Usage:
  python -m soccerdiffusion_tpu_torch.utils.import_torch_checkpoint ref.pth -o out
      [--hyperparams config.yaml]
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Mapping

import torch

from soccerdiffusion_tpu_torch.data.normalizer import Normalizer
from soccerdiffusion_tpu_torch.utils import torch_port

logger = logging.getLogger("soccerdiffusion_tpu_torch")


def extract_ema_state_dict(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Strip the ema_pytorch wrapper: keep the ``ema_model.*`` keys, without
    the wrapper's bookkeeping buffers."""
    out = {key[len("ema_model."):]: value for key, value in sd.items()
           if key.startswith("ema_model.")}
    if not out:
        raise ValueError("no ema_model.* keys found; not an EMA checkpoint")
    out.pop("initted", None)
    out.pop("step", None)
    return out


def convert(checkpoint: Mapping[str, Any], hyperparams: dict | None = None
            ) -> tuple[dict[str, torch.Tensor], Normalizer, dict]:
    """A reference checkpoint dict -> (the port's state dict, normaliser,
    hyperparameters); ``hyperparams`` wins over the embedded ones."""
    from soccerdiffusion_tpu_torch.config import Config
    from soccerdiffusion_tpu_torch.models import DiffusionPolicy
    from soccerdiffusion_tpu_torch.utils.jax_params import flax_state_dict

    if "model_state_dict" in checkpoint:
        sd = checkpoint["model_state_dict"]
        hyperparams = hyperparams or checkpoint.get("hyperparams")
    else:
        sd = checkpoint
    if any(k.startswith("ema_model.") for k in sd):
        logger.info("detected legacy EMA checkpoint; extracting ema_model weights")
        sd = extract_ema_state_dict(sd)
    if hyperparams is None:
        raise ValueError("checkpoint embeds no hyperparams; pass --hyperparams config.yaml")
    config = Config.from_dict(hyperparams)
    params, batch_stats, norm = torch_port.port_policy_state_dict(sd, config.model)
    with torch.device("meta"):
        skeleton = DiffusionPolicy(config.model)
    state_dict = flax_state_dict(skeleton, params, batch_stats or None)
    normalizer = Normalizer(mean=torch.as_tensor(norm["mean"], dtype=torch.float32),
                            std=torch.as_tensor(norm["std"], dtype=torch.float32))
    return state_dict, normalizer, dict(hyperparams)


def main(argv=None) -> None:
    from soccerdiffusion_tpu_torch.training.checkpoint import write_checkpoint

    parser = argparse.ArgumentParser(description="Import a reference (PyTorch) checkpoint")
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--hyperparams", type=str, default=None,
                        help="YAML config if the checkpoint embeds none (legacy EMA)")
    args = parser.parse_args(argv)

    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    hp = None
    if args.hyperparams:
        import yaml

        with open(args.hyperparams) as f:
            hp = yaml.safe_load(f)
    state_dict, normalizer, hyperparams = convert(raw, hp)
    epoch = raw.get("current_epoch", 0) if isinstance(raw, dict) else 0
    write_checkpoint(args.output, state_dict, {}, {}, normalizer, 0, hyperparams, epoch)
    logger.info(f"imported -> {args.output}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
