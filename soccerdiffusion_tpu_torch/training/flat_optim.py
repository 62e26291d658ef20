"""AdamW over one flat float32 buffer (counterpart of
``soccerdiffusion_tpu/training/flat_optim.py``, the ``flat_optimizer`` knob).

The JAX package ravels the parameters into one vector and runs optax's
AdamW on it (``flat_wrap``): one mu / nu pair, a handful of large fusions
instead of a few per parameter tensor. AdamW is elementwise, so the update
is the per-tensor one. Here the parameters themselves live in the buffer:
``FlatOptimizer`` copies them into one contiguous float32 buffer, a segment
per parameter group (the ``image_encoder_lr_mult`` group its own), and
rebinds each parameter, in place (``torch.utils.swap_tensors``, so every
reference to it stays valid), as a view of its slice. The view shares the
buffer's version counter, so an update in place invalidates the serving
weight caches keyed on it (``models/transformer.py:packed_weights``). A
step gathers the gradients into one flat tensor (one ``torch.cat``),
clips by its norm (``grad_clip_norm``, before AdamW as in JAX, where
``flat_wrap`` wraps the clip), and runs one ``torch.optim.AdamW`` step
over the segments: on the card one fused kernel a segment. AdamW is
computed by the library here, as the JAX package computes it with optax.

Anything that rebinds a parameter's data afterwards (``module.to()``,
``load_state_dict(assign=True)``) detaches it from the buffer: make the
optimizer after the model is on its device and split over its ranks, and
load checkpoints by copying (``training/checkpoint.py`` does). ``state_dict``
is by parameter, as the per-tensor optimizer's, each moment a view of its
segment's; a checkpoint marks which optimizer wrote it.
"""

from __future__ import annotations

import torch

from soccerdiffusion_tpu_torch.training.trainer import Optimizer, adamw, clip_by_global_norm, lr_at_step


class FlatOptimizer(Optimizer):
    """``Optimizer``'s update on one flat buffer (module docstring)."""

    flat = True

    def _make_adamw(self, groups, lr: float, weight_decay: float) -> torch.optim.AdamW:
        params = [p for g in groups.values() for _, p in g]
        device = params[0].device
        self.buffer = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                                  device=device)
        self.grads = torch.empty_like(self.buffer)
        # (start, end) of each group's segment and of each parameter's slice,
        # and the parameter indices (state_names order) of each segment
        self.segments: list[tuple[int, int]] = []
        self.slices: list[tuple[int, int]] = []
        self.segment_indices: list[list[int]] = []
        offset = 0
        with torch.no_grad():
            for g in groups.values():
                start = offset
                self.segment_indices.append(list(range(len(self.slices),
                                                       len(self.slices) + len(g))))
                for _, p in g:
                    view = self.buffer[offset:offset + p.numel()].view_as(p)
                    view.copy_(p)
                    torch.utils.swap_tensors(p, torch.nn.Parameter(view, p.requires_grad))
                    self.slices.append((offset, offset + p.numel()))
                    offset += p.numel()
                self.segments.append((start, offset))
        self.segment_params = [self.buffer[a:b] for a, b in self.segments]
        for seg, (a, b) in zip(self.segment_params, self.segments):
            seg.grad = self.grads[a:b]
        return adamw([{"params": [seg], "lr_mult": m} for seg, m in
                      zip(self.segment_params, groups)], lr, weight_decay, device.type == "cuda")

    def in_buffer(self) -> bool:
        """Whether every parameter still is its slice of the buffer."""
        base = self.buffer.data_ptr()
        return all(p.data_ptr() == base + 4 * a and p.is_contiguous()
                   for p, (a, _) in zip(self.params, self.slices))

    def step(self, count: int, norm: torch.Tensor | None = None) -> None:
        """The ``count``-th update (0-based) from the parameters' grads, every
        parameter's (the train step gives unused ones zeros); clipping by
        ``norm`` where the caller passes the norm of a split model's whole
        gradient, else by the flat gradient's."""
        if any(p.grad is None for p in self.params):
            raise ValueError("the flat optimizer updates every parameter: each needs a gradient")
        torch.cat([p.grad.reshape(-1) for p in self.params], out=self.grads)
        if self.grad_clip_norm > 0.0:
            clip_by_global_norm([self.grads], self.grad_clip_norm, norm)
        lr = lr_at_step(self.lr, self.total_steps, count)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.adamw.step()

    def state_dict(self) -> dict:
        """The AdamW state by parameter, as ``Optimizer.state_dict``: each
        moment a view of its segment's, ``step`` the segment's."""
        flat = self.adamw.state_dict()
        state = {}
        for j, (indices, (a, _)) in enumerate(zip(self.segment_indices, self.segments)):
            seg = flat["state"].get(j)
            if seg is None:
                continue
            for i in indices:
                lo, hi = self.slices[i][0] - a, self.slices[i][1] - a
                shape = self.params[i].shape
                state[i] = {"step": seg["step"], "exp_avg": seg["exp_avg"][lo:hi].view(shape),
                            "exp_avg_sq": seg["exp_avg_sq"][lo:hi].view(shape)}
        groups = [{**{k: v for k, v in g.items() if k != "params"}, "params": indices}
                  for g, indices in zip(flat["param_groups"], self.segment_indices)]
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, state: dict) -> None:
        """Moments by parameter (``state_dict``'s form, or the per-tensor
        optimizer's) concatenated into the segments' state."""
        moments = state["state"]
        flat = {}
        for j, indices in enumerate(self.segment_indices):
            if not any(i in moments for i in indices):
                continue
            missing = [self.state_names[i] for i in indices if i not in moments]
            if missing:
                raise ValueError(f"the optimizer state lacks the moments of {missing}")
            steps = {float(moments[i]["step"]) for i in indices}
            if len(steps) != 1:
                raise ValueError(f"a segment's parameters hold different step counts {steps}")
            cat = lambda key: torch.cat([torch.as_tensor(moments[i][key]).reshape(-1)
                                         for i in indices])
            flat[j] = {"step": moments[indices[0]]["step"], "exp_avg": cat("exp_avg"),
                       "exp_avg_sq": cat("exp_avg_sq")}
        self.adamw.load_state_dict({"state": flat,
                                    "param_groups": self.adamw.state_dict()["param_groups"]})
