"""The one-program event sweeps on the card: the sweep graphs against the
eager exact per-view loop (chip_smoke's phase 16 (b) bar), and a copy of
the captured graphs' shared replay (``launches.CameraGraph.replay``, the
sweep graph's and the training step's) that does not copy the camera's
inputs against the same bar.

On the card the sweeps must pass ``chip_smoke.compare_sweeps`` on the
200k-Gaussian bench scene at 544x976 over four views of one FoV, as sweep
graphs, and over four views of two FoVs, through the per-view loop with no
graph captured; with the faulty replay they must fail it on the views of
one FoV. Run
there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_sweeps_card.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need). Without a card those tests skip; the check that the fault
still applies to the shared replay's source runs everywhere.
"""
import inspect
import textwrap

import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import launches, sweep  # noqa: E402

# The fault: a replay leaves the graph's fixed camera inputs as they are, so
# every replay renders the view its graph was captured on.
FAULT = ("getattr(self.camera, f).copy_(getattr(camera, f))", "pass")


def _faulty_replay():
    src = textwrap.dedent(inspect.getsource(launches.CameraGraph.replay))
    assert src.count(FAULT[0]) == 1, f"{FAULT[0]!r} is not in CameraGraph.replay exactly once"
    namespace = dict(vars(launches))
    exec(compile(src.replace(*FAULT), launches.__file__, "exec"), namespace)
    return namespace["replay"]


def test_fault_applies_to_the_sweep_graph():
    """The fault's text is in ``CameraGraph.replay``, which the sweep graph
    replays through, exactly once."""
    assert sweep.SweepGraph.__mro__[1] is launches.CameraGraph
    _faulty_replay()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the sweep graphs are captured on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scenes(card):
    """The bench scene, and its views at one FoV and at two (every other
    view 5% wider)."""
    import chip_smoke as cs
    from reduced_3dgs_torch.dataset.camera import build_camera, sweep_cameras
    from reduced_3dgs_torch.shculling import VariableSHGaussianModel

    model = VariableSHGaussianModel(3, device=card).load_numpy(cs.bench_scene(0))
    cams = sweep_cameras([cs.view_camera(p, card) for p in cs.sweep_poses(cs.N_VIEWS)])
    wide = [c if i % 2 == 0 else build_camera(c.image_height, c.image_width, c.FoVx * 1.05,
                                              c.FoVy * 1.05, R=c.R, T=c.T, device=card)
            for i, c in enumerate(cams)]
    return model, {"one FoV": cams, "two FoVs": wide}


@pytest.fixture
def graphs(monkeypatch):
    """The number of sweep graphs captured while the test runs."""
    captured = []
    init = sweep.SweepGraph.__init__

    def counting(self, *args, **kwargs):
        captured.append(1)
        init(self, *args, **kwargs)

    monkeypatch.setattr(sweep.SweepGraph, "__init__", counting)
    return captured


@pytest.mark.cuda
@pytest.mark.parametrize("views", ["one FoV", "two FoVs"])
def test_graph_sweeps_pass_the_bar(scenes, views, graphs):
    import chip_smoke as cs
    model, cams = scenes
    cs.compare_sweeps("card test", model, cams[views], views)
    # One graph for the importance sweep, one for each pass of the cull.
    assert len(graphs) == (3 if views == "one FoV" else 0)


@pytest.mark.cuda
def test_replays_without_the_camera_fail_the_bar(scenes, monkeypatch):
    import chip_smoke as cs
    model, cams = scenes
    monkeypatch.setattr(launches.CameraGraph, "replay", _faulty_replay())
    with pytest.raises(AssertionError):
        cs.compare_sweeps("card test, faulty", model, cams["one FoV"], "one FoV")
