"""Tiny shapes of each configuration for the CPU tests: every width cut so
that a run of the harness, the reference and the port's plain kernels takes
seconds on the CPU. The benchmark never runs these."""

PROPRIO = {"hidden_dim": 32, "action_context_length": 8, "imu_context_length": 8,
           "joint_state_context_length": 8}
FLAGSHIP = {**PROPRIO, "image_resolution": 32, "vit_patch_size": 8, "vit_width": 32, "vit_depth": 1,
            "image_context_length": 4}
SERVE = {"robots": 4, "reference_rows": 2, "check_periods": 2, "trace_periods": 1,
         "warmup_periods": 5}
TRAIN = {"batch": 4, "pool": 3, "reference_rows": 2, "warmup_steps": 3, "trace_steps": 1}


def overrides(cell: dict, config: str) -> dict:
    model = FLAGSHIP if config.startswith("vit") else PROPRIO
    return {**model, **(TRAIN if cell["driver"] == "train" else SERVE)}
