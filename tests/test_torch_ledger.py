"""The port's quality ledger (``evaluation/ledger.py``) against
``examples/quality_ledger.py``: every flag and default of the example's
parser and its configuration literals, read by an AST walk of the example
(no JAX import); a ``--fast --vision`` run on the CPU with a guided 2-draw
student writing a JSON with every top-level key of the recorded run F
ledger (``docs/quality_ledger_vision_r5f.json``) and the JAX report's
sampler labels; the checks a finished camera ledger must pass; the card
refused where there is none. Torch runs on one thread (~10 s)."""

import argparse
import ast
import json
from pathlib import Path

import pytest
import torch
import yaml

from soccerdiffusion_tpu.diffusion import solver_label
from soccerdiffusion_tpu_torch.config import Config
from soccerdiffusion_tpu_torch.data.pipeline import prepare_batch
from soccerdiffusion_tpu_torch.diffusion import make_schedule
from soccerdiffusion_tpu_torch.evaluation import ledger
from soccerdiffusion_tpu_torch.models import DiffusionPolicy
from soccerdiffusion_tpu_torch.training.checkpoint import load_checkpoint
from soccerdiffusion_tpu_torch.training.distill import DistillStep
from soccerdiffusion_tpu_torch.training.train import build_dataset

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = ast.parse((REPO / "examples" / "quality_ledger.py").read_text())
R5F = json.loads((REPO / "docs" / "quality_ledger_vision_r5f.json").read_text())


def example_arguments() -> dict:
    """The example's ``parser.add_argument`` calls: flag -> keywords."""
    out = {}
    for node in ast.walk(EXAMPLE):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords if k.arg != "help"}
            out[node.args[0].value] = {
                k: v.id if isinstance(v, ast.Name) else ast.literal_eval(v) for k, v in kw.items()}
    return out


def example_literal(name: str):
    for node in EXAMPLE.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def example_fast_block() -> ast.If:
    return next(n for n in ast.walk(EXAMPLE) if isinstance(n, ast.If)
                and ast.unparse(n.test) == "args.fast")


def test_parser_has_every_flag_and_default_of_the_example():
    want = example_arguments()
    actions = {a.option_strings[0]: a for a in ledger.build_parser()._actions if a.option_strings}
    assert len(want) == 16 and set(want) <= set(actions)
    for flag, kw in want.items():
        got = actions[flag]
        assert got.default == kw.get("default", False if kw.get("action") == "store_true"
                                     else None), flag
        assert got.nargs == kw.get("nargs", 0 if kw.get("action") == "store_true" else None), flag
        assert (got.type.__name__ if got.type else None) == kw.get("type"), flag
        assert got.dest == kw.get("dest", flag.lstrip("-").replace("-", "_")), flag
        if kw.get("action"):
            assert isinstance(got, argparse._StoreTrueAction if kw["action"] == "store_true"
                              else argparse._AppendAction), flag
    assert set(actions) - set(want) == {"-h", "--device"}
    assert actions["--device"].default == "cuda"


@pytest.mark.parametrize("name", ["BENCH_CONFIG", "VISION_OVERRIDES"])
def test_configs_equal_the_example_literals(name):
    assert getattr(ledger, name) == example_literal(name)


def test_fast_cuts_equal_the_example():
    block = example_fast_block()
    updates = [{k.arg: ast.literal_eval(k.value) for k in n.keywords} for n in ast.walk(block)
               if isinstance(n, ast.Call) and ast.unparse(n.func) == "config.update"]
    assert updates == [ledger.FAST_OVERRIDES, ledger.FAST_VISION_OVERRIDES]
    caps = {n.targets[0].attr: n.value.args[1].value for n in ast.walk(block)
            if isinstance(n, ast.Assign) and ast.unparse(n.value).startswith("min(")}
    args = ledger.parse_args(["--fast", "--vision", "--train-steps", "5000"])
    config = ledger.ledger_config(args)
    assert caps == {"train_steps": 30, "distill_steps": 10, "windows": 16, "chunks": 3}
    assert {k: getattr(args, k) for k in caps} == caps
    assert config["vit_width"] == 32 and config["hidden_dim"] == 32


def test_set_wins_and_run_f_is_the_round5_recipe():
    args = ledger.parse_args(ledger.RUN_F + ledger.FUSED + ["--fast", "--set", "hidden_dim=128"])
    config = ledger.ledger_config(args)
    assert config["hidden_dim"] == 128 and config["vit_depth"] == 6  # --set over --fast
    run_f = ledger.ledger_config(ledger.parse_args(ledger.RUN_F))
    assert {k: run_f[k] for k in ("vit_depth", "boundary_oversample", "image_encoder_lr_mult",
                                  "aux_cue_head", "aux_cue_weight", "grad_clip_norm",
                                  "modality_dropout", "compute_dtype")} == {
        "vit_depth": 6, "boundary_oversample": 0.5, "image_encoder_lr_mult": 3,
        "aux_cue_head": True, "aux_cue_weight": 1, "grad_clip_norm": 1,
        "modality_dropout": 0.15, "compute_dtype": "bfloat16"}
    assert not any(k in run_f for k in ("vit_fused_block", "encoder_fused_stack",
                                        "decoder_fused_block"))
    assert all(config[k] is True for k in ("vit_fused_block", "encoder_fused_stack",
                                           "decoder_fused_block"))


@pytest.fixture(scope="module")
def fast_vision(tmp_path_factory):
    """A --fast --vision ledger on the CPU: a 1-step student of the 3.0@image
    2-draw teacher, a cfg3 guidance row, posterior means of 2."""
    tmp = tmp_path_factory.mktemp("ledger")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = ledger.main(["--fast", "--vision", "--device", "cpu", "--student-steps", "1",
                              "--student-guidance", "3.0@image", "--student-teacher-draws", "2",
                              "--guidance-rows", "3.0@image", "--posterior-mean", "2",
                              "--out", str(tmp / "ledger"), "--workdir", str(tmp / "work")])
    finally:
        torch.set_num_threads(threads)
    return tmp, result


def test_fast_vision_ledger_writes_the_run_f_keys(fast_vision):
    tmp, result = fast_vision
    written = json.loads((tmp / "ledger.json").read_text())
    assert set(R5F) <= set(written)
    assert written["train_steps"] == 30 and written["distill_steps"] == 10
    curve = [json.loads(line) for line in (tmp / "work" / "teacher_metrics.jsonl").open()]
    assert written["teacher_loss_curve"] == [[r["step"], r["loss"]] for r in curve]
    assert set(written["wall_s"]) == {"teacher", "student1", "report"}
    assert (tmp / "ledger.md").read_text().rstrip().endswith(
        f"{len(curve)} recorded points.")
    hp = load_checkpoint(tmp / "work" / "student1.ckpt")["hyperparams"]
    assert (hp["distilled_decoder"], hp["distilled_guidance_scale"],
            hp["distilled_guidance_null"], hp["distilled_teacher_draws"]) == (
        True, 3.0, ["image"], 2)
    config = yaml.safe_load((tmp / "work" / "config.yaml").read_text())
    assert config == {**ledger.BENCH_CONFIG, **ledger.VISION_OVERRIDES,
                      **ledger.FAST_OVERRIDES, **ledger.FAST_VISION_OVERRIDES}


def test_fast_vision_ledger_labels_its_rows_as_the_jax_report(fast_vision):
    _, result = fast_vision
    teacher = solver_label("ddim", ledger.FAST_OVERRIDES["distill_teacher_inference_steps"])
    assert result["checkpoints"][0]["open_loop"]["sampler"] == teacher
    assert [r["sampler"] for r in result["guidance"]] == [f"{teacher}+cfg3(image)"]
    rows = result["posterior_mean_boundary"]["rows"]
    assert [(r["name"], r["sampler"], r["nfe"]) for r in rows] == [
        ("teacher", f"{teacher}xmean2", 10), ("teacher", f"{teacher}+cfg3(image)xmean2", 20),
        ("student1.ckpt", "distilled1", 1), ("student1.ckpt", "distilled1xmean2", 2)]


def camera_ledger(mse=0.0015, floor=0.184, ratio=29.4, nan=False) -> dict:
    return {"checkpoints": [{"open_loop": {"mse": mse}}], "noise_floor_mse": floor,
            "guidance": [{"mse": float("nan") if nan else 0.003}],
            "posterior_mean_boundary": {"rows": [
                {"name": "teacher", "scale": 1.0, "ratio_shuffled_over_true": 4.8},
                {"name": "teacher", "scale": 5.0, "ratio_shuffled_over_true": ratio}]}}


@pytest.mark.parametrize("case,fault", [
    ({}, None), ({"nan": True}, "ledger.guidance[0].mse is nan"),
    ({"mse": 0.0185}, "teacher open-loop MSE"), ({"ratio": 1.99}, "boundary ratio 1.990")])
def test_ledger_faults(case, fault):
    faults = ledger.ledger_faults(camera_ledger(**case))
    assert (faults == []) if fault is None else (len(faults) == 1 and fault in faults[0])


def test_ledger_faults_needs_a_cfg5_row():
    result = camera_ledger()
    result["posterior_mean_boundary"]["rows"].pop()
    assert ledger.ledger_faults(result) == ["no teacher cfg5 posterior-mean boundary row"]


def test_cuda_is_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ledger.main(["--fast", "--vision", "--workdir", str(tmp_path / "work"),
                     "--out", str(tmp_path / "ledger")])
    assert not (tmp_path / "work").exists()


def test_teacher_draws_roll_out_as_one_batch():
    """The guided K-draw teacher of the ledger's students: its draws roll
    out as one batch of K x B rows, the mean of the K rollouts each run on
    its own (float32, the --fast --vision model)."""
    config = Config.from_dict(ledger.ledger_config(ledger.parse_args(["--fast", "--vision"])))
    torch.manual_seed(0)
    teacher = DiffusionPolicy(config.model).eval()
    dataset = build_dataset(config, 0, True)
    batch = next(dataset.batches(4, shuffle=True, seed=0))
    batch = prepare_batch({k: torch.as_tensor(v) for k, v in batch.items()}, keep_u8=True)
    step = DistillStep(teacher, make_schedule(config.train.train_denoising_timesteps), None,
                       teacher_inference_steps=5, guidance_scale=3.0, guidance_null=("image",),
                       teacher_draws=3)
    gen = torch.Generator().manual_seed(1)
    draw_noise = torch.randn((3, 4, 10, config.model.num_joints), generator=gen)
    context, mean = step.teacher_trajectory(teacher, batch, draw_noise[0], draw_noise)
    each = [step.teacher_trajectory(teacher, batch, n, None)[1] for n in draw_noise]
    assert torch.equal(context, step.teacher_trajectory(teacher, batch, draw_noise[0], None)[0])
    torch.testing.assert_close(mean, (each[0] + each[1] + each[2]) / 3, rtol=1e-5, atol=1e-5)
