"""The one path from a kernel's wrapper to its counted launch and its graph
replay (``ops/rasterize/launches.py``), on the CPU with a stub library and
a stubbed stream: ``launch`` passes tensors as their addresses in the
launcher's order, raises on a CUDA error naming the launcher and counts
nothing then, and counts a launch on the wrapper, or in the capture's tally
while the stream captures; the Adam kernel's wrapper sends each parameter's
tensors in order, NULL for a missing gradient, and counts one launch, and a
CPU state launches nothing; ``CameraGraph`` clones the camera's tensor
fields, skips those that are None, and copies another camera's fields in
before each replay, whose captured launches it counts."""
import contextlib
import dataclasses
from typing import Optional

import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import _build, composite, launches  # noqa: E402

STREAM = 0x5EED


@pytest.fixture
def stub(monkeypatch):
    """A stub library whose launchers record their arguments and return
    ``stub.err``, loaded through ``_build.load_library``; the card's stream
    and device context stubbed; ``composite_fwd``'s counts restored after."""
    calls, loaded = [], []

    class Library:
        err = 0

        def __getattr__(self, symbol):
            def launcher(*args):
                calls.append((symbol, args))
                return self.err
            return launcher

    lib = Library()
    monkeypatch.setattr(_build, "load_library", lambda name: loaded.append(name) or lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": STREAM})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(composite.composite_fwd, "launches", 0)
    monkeypatch.setitem(launches.captured_launches, "composite_fwd", 0)
    lib.calls, lib.loaded = calls, loaded
    return lib


def test_tensors_reach_the_launcher_as_their_addresses_in_order(stub):
    a, b = torch.zeros(3), torch.ones(2, dtype=torch.int32)
    launches.launch(composite.composite_fwd, "preprocess_fwd", "cuda:0", a, 7, None, 1.5, b,
                    0x1000)
    assert stub.loaded == [_build.SOURCE_OF["preprocess_fwd"]]
    assert stub.calls == [("preprocess_fwd", (a.data_ptr(), 7, None, 1.5, b.data_ptr(),
                                              0x1000, STREAM))]


@pytest.mark.parametrize("capturing", [False, True])
def test_a_launch_counts_once(stub, monkeypatch, capturing):
    """On the wrapper, or in the capture's tally while the stream captures."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    launches.launch(composite.composite_fwd, "composite_fwd", "cuda:0", torch.zeros(1))
    assert (composite.composite_fwd.launches,
            launches.captured_launches["composite_fwd"]) == ((0, 1) if capturing else (1, 0))


def test_a_cuda_error_raises_and_counts_nothing(stub):
    stub.err = 700
    with pytest.raises(RuntimeError, match="composite_bwd kernel launch failed: CUDA error 700"):
        launches.launch(composite.composite_fwd, "composite_bwd", "cuda:0", torch.zeros(1))
    assert composite.composite_fwd.launches == 0
    assert launches.captured_launches["composite_fwd"] == 0


def test_adam_reaches_its_launcher_in_order(stub, monkeypatch):
    """The Adam kernel's launcher is in the build's tables and its wrapper
    among the registered ones; each parameter's p, gradient (NULL where it
    has none), m and v reach the launcher in order with the sizes, the
    learning rates by address or by value, the advanced count and the
    betas, and the call counts one launch."""
    from reduced_3dgs_torch.trainer import optimizer
    assert _build.SOURCE_OF["adam_fused"] == "adam"
    assert len(_build.ARGTYPES["adam_fused"]) == 12
    assert optimizer.adam_fused in launches.wrappers()
    monkeypatch.setattr(optimizer.adam_fused, "launches", 0)
    params = {"a": torch.nn.Parameter(torch.zeros(5)),
              "b": torch.nn.Parameter(torch.ones(2, 3))}
    params["a"].grad = torch.ones(5)
    state = optimizer.adam_init(params)
    rate = torch.tensor(0.5)
    optimizer.adam_fused(params, state, {"a": rate, "b": 0.25})
    ((symbol, args),) = stub.calls
    n, sizes, arrays, lr_at, lrs, count, *scalars, stream = args
    assert (symbol, n, count, stream) == ("adam_fused", 2, state.count.data_ptr(), STREAM)
    assert list(sizes) == [5, 6]
    assert list(arrays) == [params["a"].data_ptr(), params["a"].grad.data_ptr(),
                            state.m["a"].data_ptr(), state.v["a"].data_ptr(),
                            params["b"].data_ptr(), None, state.m["b"].data_ptr(),
                            state.v["b"].data_ptr()]
    assert list(lr_at) == [rate.data_ptr(), None] and list(lrs)[1] == 0.25
    assert scalars == [0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999, 1e-15]
    assert int(state.count) == 1 and optimizer.adam_fused.launches == 1
    assert stub.loaded == ["adam"]


def test_a_cpu_adam_update_launches_nothing(stub):
    from reduced_3dgs_torch.trainer import optimizer
    params = {"a": torch.nn.Parameter(torch.zeros(5))}
    params["a"].grad = torch.ones(5)
    state = optimizer.adam_init(params)
    optimizer.adam_update(params, state, {"a": 0.5})
    assert stub.calls == [] and stub.loaded == []
    assert int(state.count) == 1 and bool((params["a"] < 0).all())


@dataclasses.dataclass
class Camera:
    view: torch.Tensor
    depth: Optional[torch.Tensor]
    centre: torch.Tensor


def test_camera_graph_copies_each_camera_in_before_its_replay(monkeypatch):
    """The clones are the graph's fixed inputs: each replay sees the camera
    it was given, and counts what the capture recorded."""
    seen, runs = [], []

    class Graph:
        def replay(self):
            seen.append(fixed.view.clone())

    def capture(eager, captured, device):
        runs.append(eager())
        return Graph(), runs[-1], captured(), {"composite_fwd": 2}, 0.5, None

    monkeypatch.setattr(launches, "capture_graph", capture)
    monkeypatch.setattr(composite.composite_fwd, "launches", 0)
    first = Camera(torch.zeros(2), None, torch.ones(3))
    graph = launches.CameraGraph(first, ("view", "depth", "centre"),
                                 lambda cam: cam.view + 1, lambda cam: cam.view * 2, "cuda:0")
    fixed = graph.camera
    assert graph.fields == ("view", "centre") and fixed.depth is None
    assert fixed.view is not first.view and torch.equal(fixed.view, first.view)
    assert torch.equal(graph.first, torch.ones(2)) and torch.equal(graph.out, torch.zeros(2))
    assert (graph.tally, graph.capture_s, graph.pool_bytes) == ({"composite_fwd": 2}, 0.5, None)
    for v in (3.0, 4.0):
        graph.replay(Camera(torch.full((2,), v), None, torch.full((3,), v)))
    assert [float(s[0]) for s in seen] == [3.0, 4.0] and float(fixed.centre[0]) == 4.0
    assert float(first.view[0]) == 0.0 and composite.composite_fwd.launches == 4
