"""The traced steps: two ``torch.profiler`` sessions over whole steps
after the measured window, and their reduction to what the per-layer
readers and the breakdown take.

The first session records the device's operations alone, so the host
runs at its own pace (recording every host operation slows a step of
many small launches by half and more); busy time, the window, the
device operations and the kernels' times are its. The second records
the host's operations too, and gives only the labels and lengths of the
idle gaps. Each session starts one step before its traced steps, which
take the profiler's start-up. The traced span lies between two marker
kernels on the device, each launched after a synchronise, so every
device operation of the steps inside falls inside it. Busy time is the
union of the device's kernels, copies and fills within the span; an
idle gap is a stretch of it with none, labelled by what the host was
doing at its middle: the harness's outermost span and the innermost
operation. A kernel's time is charged to its hand-written kernel's id
by the running cell's family's table (``KERNEL_NAMES``; ProGen's where
none is given). Where one session's trace lost its span, the other's
stands in.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time

from portbench import counts

MARK = "spin_kernel"  # the marker: torch.cuda._sleep's kernel
MARK_CYCLES = 1000
ATTEMPTS = 2
# The profiler keeps only the device work that it dates inside its
# session, by a conversion of the device's clock that may stray from the
# host's; the closing marker is left this long inside the session.
STOP_MARGIN_S = 0.25
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
TOP = 10
UNLABELLED = "host not traced"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # the profiler's activity type
    start_ns: int
    end_ns: int
    thread: int = 0


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds]], the most time first
    idle_gaps: list  # [[label, seconds]], the most time first
    kernel_s: dict  # hand-written kernel id -> device seconds
    device_s: float  # summed device time (overlaps counted twice)
    kinds: dict = dataclasses.field(default_factory=dict)  # kind -> events

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _HostTree:
    """Host operations of every thread, for the innermost one under a
    time. Operations of one thread nest, so the innermost holding t is
    the latest started before t or one of its ancestors."""

    def __init__(self, events: list):
        self.threads = {}
        for ev in events:
            self.threads.setdefault(ev.thread, []).append(ev)
        self.index = {}
        for tid, evs in self.threads.items():
            evs.sort(key=lambda e: (e.start_ns, -e.end_ns))
            parent, stack = [], []
            for i, ev in enumerate(evs):
                while stack and evs[stack[-1]].end_ns < ev.end_ns:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.index[tid] = ([e.start_ns for e in evs], parent)

    def holding(self, t: int) -> list:
        """Every host operation holding time t, outermost first, over
        all threads, the latest started last."""
        found = []
        for tid, evs in self.threads.items():
            starts, parent = self.index[tid]
            i = bisect.bisect_right(starts, t) - 1
            chain = []
            while i >= 0:
                if evs[i].end_ns >= t:
                    chain.append(evs[i])
                i = parent[i]
            found += chain
        return sorted(found, key=lambda e: e.start_ns)


def _label(held: list) -> str:
    spans = [e.name for e in held if e.name.startswith("portbench.")]
    ops = [e.name for e in held if not e.name.startswith("portbench.")]
    parts = ([spans[0]] if spans else []) + ([ops[-1]] if ops else [])
    return " / ".join(parts) or "no host operation"


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    name = name[:cut] if cut > 0 else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def reduce(events: list, kernel_names: dict | None = None
           ) -> Summary | None:
    """The traced span's summary, or None when the trace holds no span
    between two markers or no device operation inside it. Kernel ids
    are ``kernel_names``'s (a family's ``KERNEL_NAMES``), ProGen's where
    it is None."""
    if kernel_names is None:
        from portbench.families import progen

        kernel_names = progen.KERNEL_NAMES
    kernel_id = counts.kernel_matcher(kernel_names)
    marks = sorted((e for e in events if e.kind == "kernel"
                    and MARK in e.name), key=lambda e: e.start_ns)
    if len(marks) < 2:
        return None
    w0, w1 = marks[0].end_ns, marks[-1].start_ns
    device = [e for e in events if e.kind in DEVICE_KINDS
              and MARK not in e.name and e.end_ns > w0 and e.start_ns < w1]
    if not device or w1 <= w0:
        return None
    busy = _union([(max(e.start_ns, w0), min(e.end_ns, w1))
                   for e in device])
    busy_ns = sum(e - s for s, e in busy)
    by_name, kernel_ns = {}, {}
    for e in device:
        d = min(e.end_ns, w1) - max(e.start_ns, w0)
        key = short_name(e.name)
        by_name[key] = by_name.get(key, 0) + d
        rid = kernel_id(e.name) if e.kind == "kernel" else None
        if rid is not None:
            kernel_ns[rid] = kernel_ns.get(rid, 0) + d
    host = _HostTree([e for e in events if e.kind in HOST_KINDS])
    gaps, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            label = _label(host.holding((prev + s) // 2))
            gaps[label] = gaps.get(label, 0) + (s - prev)
        prev = max(prev, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        device_ops=[[k, v / 1e9] for k, v in top],
        idle_gaps=[[k, v / 1e9] for k, v in idle],
        kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
        device_s=sum(min(e.end_ns, w1) - max(e.start_ns, w0)
                     for e in device) / 1e9,
        kinds={k: sum(1 for e in events if e.kind == k)
               for k in sorted({e.kind for e in events})})


class Profiler:
    """One profiler session: ``start`` begins it, ``open`` and ``stop``
    mark the traced span on the device and ``stop`` ends the session.
    ``host`` records the host's operations as well as the device's."""

    def __init__(self, device, host: bool):
        self.device, self.host = device, host
        self.prof = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark(self):
        import torch

        self._sync()
        if self.device.type == "cuda":
            torch.cuda._sleep(MARK_CYCLES)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        if self.host or not acts:
            acts.append(ProfilerActivity.CPU)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()

    def open(self) -> None:
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._sync()
        time.sleep(STOP_MARGIN_S)
        self.prof.stop()

    def events(self) -> list:
        """The session's events as ``Event``s, read from the profiler's
        raw results (its parsed event tree takes far longer to build)."""
        return from_kineto(self.prof.profiler.kineto_results.events())


class Sessions:
    """The traced steps after the window: a session of the device's
    operations, then one with the host's, each one step ahead of
    ``steps`` traced steps. Call ``before(i)`` before the i-th of
    ``total`` steps and once more, with ``i == total``, after the last.
    Kernel ids are ``kernel_names``'s (``reduce``)."""

    def __init__(self, device, steps: int, kernel_names: dict):
        self.device, self.steps = device, int(steps)
        self.kernel_names = kernel_names
        self.total = 2 * (self.steps + 1)
        self.profs = []

    def before(self, i: int) -> None:
        k, r = divmod(i, self.steps + 1)
        if r == 0:
            if k > 0:
                self.profs[-1].stop()
            if k < 2:
                self.profs.append(Profiler(self.device, host=k == 1))
                self.profs[-1].start()
        elif r == 1:
            self.profs[-1].open()

    def summary(self) -> Summary | None:
        """The device session's summary, with the idle gaps of the host
        session; None where neither holds a traced span. Each session's
        trace is named on standard error. Where one session lost its
        span the other stands in: the host session's busy time and
        kernels are the same work's, only its window is longer, and
        without the host session the idle time goes unlabelled."""
        found = []
        for p in self.profs:
            events = p.events()
            found.append(reduce(events, self.kernel_names))
            if self.device.type == "cuda":
                kinds = {}
                for e in events:
                    kinds[e.kind] = kinds.get(e.kind, 0) + 1
                marks = [(e.kind, e.start_ns, e.end_ns) for e in events
                         if MARK in e.name]
                print(f"portbench: the {'host' if p.host else 'device'} "
                      f"session's trace: {len(events)} events {kinds}, "
                      f"markers {marks}, span "
                      f"{'lost' if found[-1] is None else 'found'}",
                      file=sys.stderr, flush=True)
        self.profs = []
        device, host = found
        if device is None:
            return host
        device.idle_gaps = (host.idle_gaps if host is not None else
                            [[UNLABELLED, device.window_s - device.busy_s]])
        return device


def traced(device, steps: int, drive, kernel_names: dict
           ) -> Summary | None:
    """The traced steps' summary: ``drive(sessions)`` runs
    ``sessions.total`` steps, calling ``sessions.before`` as it says. A
    trace that holds no span on the card is taken once more. Kernel ids
    are ``kernel_names``'s (``reduce``)."""
    for _ in range(ATTEMPTS):
        sessions = Sessions(device, steps, kernel_names)
        drive(sessions)
        summary = sessions.summary()
        if summary is not None or device.type != "cuda":
            return summary
    return None


def _runtime(name: str) -> bool:
    """A call into the CUDA runtime (cudaLaunchKernel) or the layer
    beneath it (cuLaunchKernel)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def from_kineto(raw) -> list:
    """``Event``s from the profiler's raw events, their kinds worked out
    from the device each ran on: a device event named as a host
    annotation is that annotation's mirror on the device's timeline,
    not work; a host event is a runtime call or an operation."""
    from torch.autograd import DeviceType

    raw = list(raw)
    host_names = {e.name() for e in raw
                  if e.device_type() == DeviceType.CPU}
    out = []
    for e in raw:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            kind = "cuda_runtime" if _runtime(name) else "cpu_op"
        elif name in host_names:
            kind = "gpu_user_annotation"
        elif name.startswith("Memcpy"):
            kind = "gpu_memcpy"
        elif name.startswith("Memset"):
            kind = "gpu_memset"
        else:
            kind = "kernel"
        out.append(Event(name, kind, e.start_ns(), e.end_ns(),
                         e.start_thread_id()))
    return out
