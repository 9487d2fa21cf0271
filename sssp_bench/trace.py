"""The reduction of a ``torch.profiler`` trace of the measured window to the
device's busy time, its copies, its top operations and its idle gaps."""
from __future__ import annotations

import collections
import re
import time

import torch


def short_name(name: str) -> str:
    """A device event's name without its C++ template and argument lists:
    the kernel's own name, with the functor it applies where it has one
    (``vectorized_elementwise_kernel[CUDAFunctor_add]``)."""
    s = name.replace("void ", "").replace("(anonymous namespace)::", "")
    base = re.match(r"[\w:]+", s)
    if base is None or name.startswith("Memcpy") or name.startswith("Memset"):
        return name[:100]
    out = base.group(0).replace("at::native::", "")
    functor = re.search(r"(\w*Functor\w*)", s)
    if functor:
        out += f"[{functor.group(1)}]"
    return out[:100]


class DeviceTrace:
    """Profiles the device over a ``with`` block (CUDA activity only, so the
    host pays little for it).  After the block: ``events`` as ``(name,
    start_s, end_s)`` relative to the block's start, ``window_s`` its
    length, ``t0`` its start on ``time.perf_counter``'s clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: list = []
        self.window_s = 0.0
        self.t0 = 0.0

    def __enter__(self):
        act = torch.profiler.ProfilerActivity
        # on the CPU (the tests) the trace holds no device event
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if self.device.type == "cuda" else act.CPU])
        self._prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        self._wall0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        self.events = self._device_events()
        return False

    def _device_events(self) -> list:
        res = self._prof.profiler.kineto_results
        evs = [e for e in res.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        # the trace stamps events in Unix-epoch nanoseconds
        base = self._wall0_ns
        out = [(e.name(), (e.start_ns() - base) * 1e-9,
                (e.start_ns() - base + e.duration_ns()) * 1e-9) for e in evs]
        out.sort(key=lambda x: x[1])
        return out

    def busy(self) -> list:
        """The union of the device events' intervals, as sorted ``(start,
        end)`` pairs."""
        merged: list = []
        for _, s, e in self.events:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def seconds_of(self, fragment: str) -> float:
        """Summed device time of the events whose name holds ``fragment``
        (``"Memcpy HtoD"``: host-to-device copies)."""
        return sum(e - s for name, s, e in self.events if fragment in name)

    def seconds_of_kernels(self, names) -> float:
        """Summed device time of the events whose short name is in
        ``names``."""
        return sum(e - s for name, s, e in self.events
                   if short_name(name) in names)

    def top_ops(self, k: int = 10) -> list:
        acc: collections.Counter = collections.Counter()
        for name, s, e in self.events:
            acc[short_name(name)] += e - s
        return [[name, sec] for name, sec in acc.most_common(k)]

    def idle_gaps(self, spans: list, k: int = 10) -> list:
        """The ``k`` longest gaps with nothing on the device, each named by
        the innermost host span (``(name, t0, t1, depth)`` on
        ``perf_counter``'s clock) around the gap's middle, ``"host"`` where
        none is."""
        busy = self.busy()
        gaps = []
        prev = 0.0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.window_s > prev:
            gaps.append((prev, self.window_s))
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        out = []
        for s, e in gaps[:k]:
            mid = self.t0 + (s + e) / 2
            best, depth = "host", -1
            for name, t0, t1, d in spans:
                if t0 <= mid <= t1 and d > depth:
                    best, depth = name, d
            out.append([best, e - s])
        return out
