"""The end-to-end times are statistics of the whole window: a stall inside
it moves them. The drivers read a clock that advances 0.1 s a reading, and
the stall advances it by 1 s, so the test does not depend on the CPU's
speed."""
from types import SimpleNamespace

from conftest import tiny_run


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.1
        return self.t


def fake_time(monkeypatch, module):
    clock = Clock()
    monkeypatch.setattr(module, "time", SimpleNamespace(perf_counter=clock.perf_counter))
    return clock


def test_step_ms_counts_a_stall(monkeypatch):
    from gpubench import program
    from gpubench.drivers import train
    fake_time(monkeypatch, train)
    base = tiny_run("truck-flagship.steady", seconds=0.3)
    assert base["metrics"]["step_ms"]["value"] * base["attempted"] < 1000.0

    clock = fake_time(monkeypatch, train)
    armed = {"on": False}
    log, window = program.log, train.Loop.window

    def arming_log(ctx, msg):
        armed["on"] = armed["on"] or msg == "set-up done"
        log(ctx, msg)

    def stalling_window(self, limit=None):
        if armed["on"]:
            armed["on"] = False
            clock.t += 1.0
        window(self, limit)

    monkeypatch.setattr(program, "log", arming_log)
    monkeypatch.setattr(train.Loop, "window", stalling_window)
    stalled = tiny_run("truck-flagship.steady", seconds=0.3)
    assert stalled["metrics"]["step_ms"]["value"] * stalled["attempted"] >= 1000.0


def test_frame_ms_counts_a_stall(monkeypatch):
    from gpubench.drivers import render
    from reduced_3dgs_torch import viewer
    fake_time(monkeypatch, render)
    base = tiny_run("truck-flagship.render", seconds=0.5)["metrics"]["frame_ms"]["value"]
    assert base < 1000.0

    clock = fake_time(monkeypatch, render)
    render_image = viewer.ViewerApp.render_image
    calls = {"n": 0}

    def stalling(self, *a, **k):
        calls["n"] += 1
        if calls["n"] > 1:                  # every frame past the warm-up frame
            clock.t += 1.0
        return render_image(self, *a, **k)

    monkeypatch.setattr(viewer.ViewerApp, "render_image", stalling)
    assert tiny_run("truck-flagship.render", seconds=0.5)["metrics"]["frame_ms"]["value"] >= 1000.0
