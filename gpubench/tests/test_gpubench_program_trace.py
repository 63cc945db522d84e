"""The reduction of the program's ``r3dgs.*`` spans and counters
(``gpubench.program_trace``) on synthetic profiler events, its readers, and
the tiny traced cells through it."""
from types import SimpleNamespace

import pytest
import torch

from conftest import CELLS, SEED, TINY
from gpubench import program_trace, run, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def host(name, start, end, thread=1, cid=0, annotation=False):
    return SimpleNamespace(name=name, device_type=CPU, thread=thread, id=cid,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def dev(name, start, end, cid, annotation=False):
    return SimpleNamespace(name=name, device_type=CUDA, thread=0, id=cid,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def region(name, start, end, thread=1):
    """A program span and its shadow on the device's timeline."""
    return [host(name, start, end, thread, annotation=True),
            dev(name, start + 1, end + 1, 0, annotation=True)]


def step_events(with_regions=True):
    """One step: the forward's kernel launched in window > step > forward >
    render > composite, the backward's launched by another thread while the
    main thread waits in r3dgs.backward, then a frame copy whose gap opens
    in r3dgs.sync.frame_copy. Times in microseconds."""
    ops = [host("gpubench.traced_window", 0, 1000, annotation=True),
           host("aten::mul", 110, 130), host("cudaLaunchKernel", 115, 118, cid=7),
           dev("fwd_kernel", 200, 300, 7),
           host("cudaLaunchKernel", 410, 412, thread=2, cid=8),
           dev("bwd_kernel", 420, 600, 8),
           host("cudaMemcpyAsync", 705, 706, cid=9), dev("Memcpy DtoH", 710, 720, 9),
           host("cudaStreamSynchronize", 707, 725),
           host("cudaLaunchKernel", 880, 882, cid=10), dev("next_kernel", 900, 950, 10)]
    if with_regions:
        ops += (region("r3dgs.window", 10, 850) + region("r3dgs.step", 20, 840)
                + region("r3dgs.forward", 100, 390) + region("r3dgs.render", 105, 380)
                + region("r3dgs.composite", 110, 200) + region("r3dgs.backward", 400, 690)
                + region("r3dgs.sync.frame_copy", 700, 760))
    return ops


def test_a_launch_in_nested_spans_goes_to_the_innermost():
    spans = program_trace.program_spans(step_events())
    for name in ("forward", "render", "composite"):
        assert spans[name]["device_s"] == pytest.approx(100e-6), name
    assert spans["window"]["device_s"] == pytest.approx(290e-6)
    assert spans["composite"]["self_device_s"] == pytest.approx(100e-6)
    assert spans["render"]["self_device_s"] == spans["forward"]["self_device_s"] == 0.0
    assert spans["composite"]["count"] == 1
    assert spans["composite"]["host_s"] == pytest.approx(90e-6)


def test_a_launch_on_another_thread_goes_to_backward():
    spans = program_trace.program_spans(step_events())
    assert spans["backward"]["device_s"] == pytest.approx(180e-6)
    assert spans["backward"]["self_device_s"] == pytest.approx(180e-6)
    assert spans["forward"]["device_s"] == pytest.approx(100e-6)
    assert spans["step"]["device_s"] == pytest.approx(290e-6)


def test_an_idle_gap_opening_in_a_sync_goes_to_sync_idle():
    spans = program_trace.program_spans(step_events())
    # The gaps open at 300 (in forward), 600 (in backward) and 720 (in the copy).
    assert spans["step"]["idle_s"] == pytest.approx((120 + 110 + 180) * 1e-6)
    assert spans["sync.frame_copy"]["idle_s"] == pytest.approx(180e-6)
    assert spans["backward"]["idle_s"] == pytest.approx(110e-6)
    assert spans["sync.frame_copy"]["sync_calls"] == 1
    record = {"program_spans": spans, "units": 2}
    assert run.metric_reader("sync_idle.render")(record) == pytest.approx(0.09)
    assert run.metric_reader("backward_idle.camera")(record) == pytest.approx(0.055)
    assert run.metric_reader("backward_ms.camera")(record) == pytest.approx(0.09)


def test_existing_record_keys_do_not_move_with_program_regions():
    """The regions and their device shadows leave every key of today's
    record as it was, but for the names of idle gaps that now open inside
    a program span (the gaps themselves keep their lengths)."""
    plain = trace.reduce_events(step_events(False), 1e-3)
    spanned = trace.reduce_events(step_events(True), 1e-3)
    for key in ("window_s", "busy_s", "kernels", "launches", "spans"):
        assert spanned[key] == plain[key], key
    assert spanned["breakdown"]["device_ops"] == plain["breakdown"]["device_ops"]
    assert ([s for _, s in spanned["breakdown"]["idle_gaps"]]
            == [s for _, s in plain["breakdown"]["idle_gaps"]])
    assert not any(n.startswith("r3dgs.") for n in spanned["kernels"])
    assert ["r3dgs.sync.frame_copy", 180e-6] in [
        [n, pytest.approx(s)] for n, s in spanned["breakdown"]["idle_gaps"]]


def test_readers_return_none_without_the_program_keys():
    bare = {"units": 4, "kernels": {}, "spans": {}}
    for names in program_trace.METRICS.values():
        for name in names:
            assert run.metric_reader(name)(bare) is None, name
    counted = {"units": 4, "program_counters": {"host_syncs": 2}}
    assert run.metric_reader("host_syncs.render")(counted) == 0.5
    assert run.metric_reader("host_syncs.train")({"units": 4, "program_counters": {}}) == 0.0


def test_counter_delta():
    assert program_trace.counter_delta(None, {"a": 1}) is None
    assert program_trace.counter_delta({"a": 1, "b": 2}, {"a": 3, "b": 2, "c": 1}) == {
        "a": 2, "b": 0, "c": 1}


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_cells_report_every_program_metric(cell):
    torch.set_num_threads(4)
    with program_trace.program_record() as records:
        result = run.execute(cell, SEED, 0.5, True, "cpu", overrides=TINY)
    assert result["correct"] is True
    (record,) = records
    assert record["program_counters"] is not None
    assert "host_syncs" in record["program_counters"] or cell == "truck-flagship.steady"
    for name in program_trace.METRICS[cell]:
        value = run.metric_reader(name)(record)
        assert value is not None and value >= 0.0, name
    unit_span = "frame" if cell.endswith(".render") else "forward"
    assert record["program_spans"][unit_span]["count"] == record["units"]
