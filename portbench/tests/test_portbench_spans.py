"""The span fold (harness/spans.py): on hand-made events, where each device
operation and each span goes; on a CPU profile of each tiny cell, the
calls and host ms of every ``cd360.*`` span against the profiler's own
event tree; on the card, each op wrapper's span against its kernels found
by name."""
from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType

from harness import cell, readers, spans, spec
from harness import trace as tracing

SEED = 2**31 + 777


class Event:
    """The part of a kineto event the fold reads; times in microseconds."""

    def __init__(self, name, start, end, tid=1, corr=0, device=False, annotation=False):
        self._v = (name, int(start * 1e3), int(end * 1e3), tid, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[6]


def kernel(start, end, corr):
    return Event("kernel", start, end, tid=7, corr=corr, device=True)


def test_fold_places_launches_by_thread_and_time():
    main, grad = 1, 2
    events = [
        Event("cd360.train.step", 0, 100, main, corr=11, annotation=True),
        Event("cd360.train.forward", 0, 40, main, annotation=True),
        Event("cd360.train.backward", 40, 90, main, annotation=True),
        Event("cd360.nerf", 50, 60, grad, annotation=True),  # the recompute, autograd's thread
        Event("aten::mm", 5, 20, main, corr=1),  # a torch op's own ids never match a launch
        Event("cudaLaunchKernel", 10, 11, main, corr=1),
        Event("cudaLaunchKernel", 55, 56, grad, corr=2),
        Event("cuLaunchKernel", 70, 71, grad, corr=3),  # no span open on its thread
        Event("cudaMemcpyAsync", 120, 121, main, corr=5),  # inside no span
        kernel(12, 17, 1), kernel(57, 67, 2), kernel(72, 74, 3),
        kernel(80, 81, 4),  # its launch is not in the trace
        kernel(122, 125, 5),
        Event("cd360.train.step", 20, 30, 7, corr=11, device=True, annotation=True),
    ]
    fold = spans.read(events, units=1)
    s = fold.spans
    assert {k: v.calls for k, v in s.items()} == {
        "cd360.train.step": 1, "cd360.train.forward": 1, "cd360.train.backward": 1,
        "cd360.nerf": 1}
    assert s["cd360.train.forward"].device_ms == pytest.approx(0.005)
    assert s["cd360.nerf"].device_ms == pytest.approx(0.010)
    assert s["cd360.train.backward"].device_ms == pytest.approx(0.012)  # nerf's and its own
    assert s["cd360.train.step"].device_ms == pytest.approx(0.017)
    assert [s[k].launches for k in ("cd360.train.step", "cd360.train.backward",
                                    "cd360.nerf")] == [3, 2, 1]
    assert fold.top_ms == pytest.approx(0.017)
    assert fold.unmatched_ms == pytest.approx(0.001)
    assert fold.outside_ms == pytest.approx(0.003)
    assert fold.busy_ms == pytest.approx(0.021)
    assert s["cd360.train.step"].host_ms == pytest.approx(0.100)
    assert s["cd360.train.step"].self_ms == pytest.approx(0.010)
    assert s["cd360.train.backward"].self_ms == pytest.approx(0.040)
    assert s["cd360.nerf"].self_ms == pytest.approx(0.010)
    # the device busy 12-17, 57-67, 72-74, 80-81 inside the step's 0-100
    assert s["cd360.train.step"].idle_ms == pytest.approx(0.082)
    assert s["cd360.nerf"].idle_ms == pytest.approx(0.007)
    # the gaps 17-57, 67-72, 74-80 and 81-122 by the span open at their middle
    assert fold.idle_by_span == pytest.approx({
        "cd360.train.forward": 0.040, "cd360.train.backward": 0.005 + 0.006,
        spans.NO_SPAN: 0.041})


def test_fold_keeps_the_sampler_steps_without_a_render():
    events = [Event("cd360.sample", 0, 100, annotation=True),
              Event("cd360.sample.step", 10, 30, annotation=True),
              Event("cd360.nerf", 12, 20, annotation=True),
              Event("cd360.sample.step", 30, 40, annotation=True),
              Event("cd360.sample.step", 40, 55, annotation=True),
              Event("cudaLaunchKernel", 31, 32, corr=1), kernel(33, 35, 1),
              Event("cudaLaunchKernel", 41, 42, corr=2), kernel(43, 44, 2),
              Event("cudaLaunchKernel", 45, 46, corr=3), kernel(47, 48, 3)]
    fold = spans.read(events, units=1)
    assert fold.spans["cd360.sample.step"].calls == 3
    assert fold.steps == pytest.approx([(0.010, 0.002, 1), (0.015, 0.002, 2)])
    assert fold.step_mean(0) == pytest.approx(0.0125)
    assert fold.step_mean(2) == pytest.approx(1.5)
    assert spans.read([e for e in events if "cd360" not in e.name()], 1).spans == {}


def _job(bench_dir, name, device):
    wl = spec.workload(name, bench_dir)
    mix = spec.traffic(wl["traffic"], bench_dir)
    c = cell.Cell(name, wl, spec.config(wl["config"], bench_dir), mix, SEED,
                  torch.device(device), bench_dir)
    return spec.kind(mix["kind"], bench_dir).Job(c)


@pytest.mark.parametrize("name", ["tiny.sample", "tiny.train", "tiny.ae"])
def test_fold_of_a_tiny_cell_on_the_cpu(tiny_bench, name):
    job = _job(tiny_bench, name, "cpu")
    prof = tracing.profiler()
    with prof:
        job.unit(-5)
    fold = spans.read(prof.profiler.kineto_results.events(), 1)
    want = {}
    for e in prof.events():
        if e.name.startswith("cd360."):
            n, ms = want.get(e.name, (0, 0.0))
            want[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = {"tiny.sample": "cd360.sample", "tiny.train": "cd360.train.step",
           "tiny.ae": "cd360.ae.step"}[name]
    assert top in want
    assert {k: v.calls for k, v in fold.spans.items()} == {k: n for k, (n, _) in want.items()}
    for k, (_, ms) in want.items():
        assert fold.spans[k].host_ms == pytest.approx(ms, rel=1e-3, abs=2e-3), k
        assert 0.0 <= fold.spans[k].self_ms <= fold.spans[k].host_ms + 1e-9
    assert fold.busy_ms == 0.0
    ctx = cell.Context(1.0, {}, None, {}, job)
    assert spans.of(ctx) is spans.of(ctx)
    assert spans.of(ctx).per_unit(top, "host_ms") is None  # no device trace to read


OP_KERNELS = {  # each op wrapper's span -> its kernels by name (harness/readers.py)
    "cd360.op.attention": readers.ATTENTION[1],
    "cd360.op.bilinear": ("bilinear_kernel",),
    "cd360.op.bilinear_bwd": ("bilinear_bwd_kernel", "bilinear_bwd_merge_kernel"),
    "cd360.op.layer_norm": ("layer_norm_kernel",),
    "cd360.op.group_norm": readers.GROUP_NORM[1],
    "cd360.op.conv3x3": ("conv3x3_kernel",),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny.sample", "tiny.train", "tiny.ae"])
def test_op_spans_hold_their_kernels_on_the_card(tiny_bench, cuda_card, name):
    job = _job(tiny_bench, name, str(cuda_card))
    prof = tracing.profiler()
    with prof:
        job.unit(-5)
        torch.cuda.synchronize()
    fold = spans.read(prof.profiler.kineto_results.events(), 1)
    by_name = tracing.read(prof, 1, 1.0)
    ops = [k for k in OP_KERNELS if k in fold.spans]
    assert ops and fold.unmatched_ms <= 0.01 * fold.busy_ms
    for k in ops:
        want = by_name.device_s(*OP_KERNELS[k]) * 1e3
        assert fold.spans[k].device_ms == pytest.approx(want, rel=0.01), k
