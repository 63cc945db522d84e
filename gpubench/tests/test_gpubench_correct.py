"""What decides ``correct``, at a tiny size on the CPU: the control (the
reference in bfloat16 in the program's place) and each fault a cell can
have fail the cell's limits, and the program with a fault planted in its
timed path makes a run come out not correct."""
import pytest
import torch

from conftest import TINY, tiny_run
from gpubench import control, correctness, run


def cell(name):
    wl, cfg = run.cell(name)
    return {**cfg, **TINY["config"]}, {**wl, **TINY["workload"]}


@pytest.mark.parametrize("name", ["truck-flagship.steady", "truck-camera.steady"])
def test_training_control_and_faults_fail(name):
    cfg, wl = cell(name)
    readings = control.training_readings(cfg, wl, 77, torch.device("cpu"))
    for variant, numbers in readings.items():
        ok, checks = correctness.verdict(numbers, {k: v for k, v in wl["limits"].items()
                                                   if k != "failed_steps"})
        assert not ok, (variant, checks)


def test_render_control_and_fault_fail():
    cfg, wl = cell("truck-flagship.render")
    cfg["image_height"], cfg["image_width"] = 96, 144     # room for the bf16 rounding
    for variant, numbers in control.render_readings(cfg, wl, 78, torch.device("cpu")).items():
        assert not correctness.verdict(numbers, wl["limits"])[0], variant


def test_state_unchanged_fails(monkeypatch):
    from reduced_3dgs_torch.trainer import base

    def frozen(params, state, lrs, **kw):
        state.count.add_(1)
        return state

    monkeypatch.setattr(base, "adam_update", frozen)
    result = tiny_run("truck-flagship.steady")
    assert result["correct"] is False and result["checks"]["change_gap"]["value"] > 0.5


def test_wrong_later_gradient_fails(monkeypatch):
    """Gradients 10% off from the second step on (the steps that a window
    replays on the card) leave the first gradient and the change within
    their limits and fail the last compared step's gradient."""
    from reduced_3dgs_torch.trainer import base
    adam, calls = base.adam_update, []

    def scaled(params, state, lrs, **kw):
        calls.append(1)
        if len(calls) > 1:
            for p in params.values():
                if p.grad is not None:
                    p.grad.mul_(1.1)
        return adam(params, state, lrs, **kw)

    monkeypatch.setattr(base, "adam_update", scaled)
    result = tiny_run("truck-flagship.steady")
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    assert checks["last_grad_gap"]["value"] > checks["last_grad_gap"]["limit"]


def test_half_batch_fails(monkeypatch):
    from reduced_3dgs_torch.trainer import base
    l1 = base.l1_loss
    monkeypatch.setattr(base, "l1_loss", lambda a, b: l1(a[:, :a.shape[1] // 2],
                                                        b[:, :b.shape[1] // 2]))
    assert tiny_run("truck-flagship.steady")["correct"] is False


@pytest.mark.parametrize("name", ["truck-flagship.steady", "truck-camera.steady",
                                  "truck-flagship.render"])
def test_altered_answer_fails(monkeypatch, name):
    from reduced_3dgs_torch.ops.rasterize import tiled
    assemble = tiled._assemble_outputs

    def altered(*args, **kwargs):
        out = assemble(*args, **kwargs)
        bump = torch.zeros_like(out["render"])
        bump[:, :16, :16] = 0.05
        out["render"] = out["render"] + bump
        return out

    monkeypatch.setattr(tiled, "_assemble_outputs", altered)
    assert tiny_run(name)["correct"] is False


@pytest.mark.cuda
def test_sound_card_run(card):
    from conftest import SEED
    from gpubench import run as harness
    for name in ("truck-flagship.steady", "truck-flagship.render"):
        result = harness.execute(name, SEED, 0.5, False, str(card), overrides=TINY)
        assert result["correct"] is True, result["checks"]
