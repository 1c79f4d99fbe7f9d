"""Reading a ``torch.profiler`` trace: device time by kernel name, the
device's busy time (the union of its operations' intervals), kernel counts,
and the idle gaps on the device named by what the host was doing then."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

TOP = 10  # entries of each breakdown list


def profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


@dataclass
class Trace:
    """One traced window of ``units`` images or steps."""

    units: int
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> [seconds, count]
    idle_by_host: dict = field(default_factory=dict)  # host op -> seconds

    def device_s(self, *names) -> float:
        """Device seconds of the kernels whose name, in lower case, holds
        one of ``names``."""
        return sum(s for k, (s, _) in self.kernels.items() if any(n in k.lower() for n in names))

    def launches(self) -> int:
        return sum(c for _, c in self.kernels.values())

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _host_at(starts, cpu, t, scan=4000):
    """The innermost host op running at ``t`` (ns): of the ops that started
    by then, the latest-starting one that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host: Python between ops"


def read(prof, units: int, window_s: float) -> Trace:
    """The trace of ``units`` images or steps in a profiled window of
    ``window_s`` seconds (host clock). Device operations: every event on a
    CUDA device but the user annotations; host ops: the CPU events that are
    not CUDA runtime calls."""
    tr = Trace(units=units, window_s=window_s)
    dev, cpu = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            dev.append((start, end))
            k = kernels[e.name()]
            k[0] += (end - start) * 1e-9
            k[1] += 1
        elif not e.name().startswith(("cuda", "Runtime", "Activity Buffer")):
            cpu.append((start, end, e.name()))
    tr.kernels = dict(kernels)
    merged = _merge(dev)
    tr.busy_s = sum(hi - lo for lo, hi in merged) * 1e-9
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        idle[_host_at(starts, cpu, (a + b) // 2)] += (b - a) * 1e-9
    tr.idle_by_host = dict(idle)
    return tr
