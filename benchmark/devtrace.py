"""The traced window: torch.profiler over a few units, reduced to device
time by kernel, by layer and by the program's spans, the device's busy
time, and its idle gaps named by what the host was doing.

The reduction takes plain records, so that it can be tested without a
card: device intervals (kernels, copies and sets, each with the host time
and thread of its launch where the trace links them), host intervals (the
operators and runtime calls PyTorch records, and the benchmark's own
``bench.*`` ranges), span intervals (the host extents of the program's own
``record_function`` ranges) and the window.

A span's device time is that of the kernels launched inside it. The
profiler's device-side mirror of a range cannot give it: it covers only
the kernels launched with that range innermost (on an H100 under PyTorch
2.11, an outer range's mirror spanned one of its three kernels, the two
launched inside a nested range left out).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import NamedTuple

WINDOW = "bench.window"


class Interval(NamedTuple):
    start: float   # seconds
    end: float
    name: str
    thread: int = 0              # host thread (of the launch, for a kernel)
    launch: float | None = None  # a kernel's launch on the host, if linked


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)   # base name -> seconds
    layer_s: dict = field(default_factory=dict)    # layer -> seconds
    span_s: dict = field(default_factory=dict)     # program span -> seconds
    idle_by_host: dict = field(default_factory=dict)  # label -> seconds


def _demangle_last(s: str) -> str:
    """The last plain identifier of an Itanium-mangled function name
    (``_Z8pivot_gj...`` -> ``pivot_gj``, ``_ZN2at6native4kernIi...`` ->
    ``kern``), enough to name a kernel."""
    i, last = 2, s
    nested = s[i:i + 1] == "N"
    i += nested
    while i < len(s):
        while s[i:i + 1] in ("K", "V", "L"):
            i += 1
        m = re.match(r"\d+", s[i:])
        if not m:
            break
        j = i + len(m.group())
        last = s[j:j + int(m.group())]
        i = j + int(m.group())
        if not nested:
            break
    return last


def base_name(name: str) -> str:
    """A device function's name without return type, namespace, template
    arguments and parameters: ``void ns::k<16, 80>(float2*)`` -> ``k``,
    mangled names likewise; copies keep their kind (``Memcpy HtoD``)."""
    s = name.strip()
    if s.startswith("_Z"):
        return _demangle_last(s)
    if s.startswith("void "):
        s = s[5:]
    s = s.replace("(anonymous namespace)::", "")
    s = re.split(r"[(<]", s, maxsplit=1)[0].strip()
    return s.split("::")[-1] or name


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labels(host: list[Interval], thread: int, points: list) -> list:
    """For each time in ``points`` (ascending), "range/op": the
    benchmark's innermost ``bench.*`` range and the innermost host interval
    of ``thread`` around it. Host intervals of one thread nest, so a sweep
    with a stack of the open ones finds both."""
    ev = sorted((h for h in host if h.thread == thread and h.name != WINDOW),
                key=lambda h: (h.start, -h.end))
    stack, out, j = [], [], 0
    for t in points:
        while j < len(ev) and ev[j].start <= t:
            while stack and stack[-1].end <= ev[j].start:
                stack.pop()
            stack.append(ev[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        op = next((h.name for h in reversed(stack)
                   if not h.name.startswith("bench.")), "python")
        rng = next((h.name for h in reversed(stack)
                    if h.name.startswith("bench.")), "bench")
        out.append(f"{rng}/{op}")
    return out


def _launched_inside(kernels, spans: list[Interval]) -> float:
    """Seconds of the clipped (start, end, kernel) ``kernels`` whose launch
    falls inside the union of ``spans`` on the launching thread."""
    unions = {}
    for th in {sp.thread for sp in spans}:
        u = _union((sp.start, sp.end) for sp in spans if sp.thread == th)
        unions[th] = ([a for a, _ in u], [b for _, b in u])
    total = 0.0
    for s, e, k in kernels:
        if k.launch is None or k.thread not in unions:
            continue
        starts, ends = unions[k.thread]
        i = bisect.bisect_right(starts, k.launch) - 1
        if i >= 0 and k.launch <= ends[i]:
            total += e - s
    return total


def summarize(device: list[Interval], host: list[Interval],
              layers: dict, spans: list[Interval] = ()) -> Summary:
    """Reduce the records of one traced window. ``layers`` maps a base
    kernel name to its layer. A span's time is the device time (within the
    window) of the kernels launched inside its intervals, taken as one union
    a name: nested spans each count the kernels launched inside them, a
    kernel counts once in each, and a span that launched none reads 0."""
    win = [h for h in host if h.name == WINDOW]
    if not win:
        raise ValueError("the trace holds no bench.window range")
    w0, w1 = win[0].start, win[0].end
    clipped = [(max(d.start, w0), min(d.end, w1), d) for d in device
               if d.end > w0 and d.start < w1]
    busy = _union((s, e) for s, e, _ in clipped)
    kernel_s: dict = {}
    for s, e, d in clipped:
        b = base_name(d.name)
        kernel_s[b] = kernel_s.get(b, 0.0) + (e - s)
    layer_s: dict = {}
    for b, t in kernel_s.items():
        if b in layers:
            layer_s[layers[b]] = layer_s.get(layers[b], 0.0) + t
    by_name: dict = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    span_s = {n: _launched_inside(clipped, sps) for n, sps in by_name.items()}
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: dict = {}
    for (s, e), lab in zip(gaps, _labels(host, win[0].thread,
                                          [0.5 * (s + e) for s, e in gaps])):
        idle[lab] = idle.get(lab, 0.0) + (e - s)
    return Summary(window_s=w1 - w0, busy_s=sum(e - s for s, e in busy),
                   kernel_s=kernel_s, layer_s=layer_s, span_s=span_s,
                   idle_by_host=idle)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


RUNTIME = re.compile(r"cu(da)?[A-Z]\w*$")  # a CUDA runtime or driver call


def records(prof):
    """(device, host, spans) intervals of a finished
    ``torch.profiler.profile``: device kernels, copies and sets (without
    the device-side mirrors of annotations), each with the host time and
    thread of its launch, the runtime or driver call of the same
    correlation id (``cudaLaunchKernel`` for the port's kernels, which no
    operator wraps; ``cuLaunchKernel`` for a library's); host operators,
    runtime calls and annotations; and the program's own annotations (every
    ``record_function`` range not named ``bench.*``)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    device, host, spans = [], [], []
    runtime = {}   # correlation id of a launch -> (start, thread)
    kernels = []
    for e in events:
        start = (e.start_ns() - base) * 1e-9
        end = start + e.duration_ns() * 1e-9
        kind = str(getattr(e, "activity_type", lambda: "")())
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == DeviceType.CUDA:
            if not annotation and "annotation" not in kind:
                kernels.append((start, end, e))
        elif e.device_type() == DeviceType.CPU and not e.is_async():
            h = Interval(start, end, e.name(), e.start_thread_id())
            host.append(h)
            if RUNTIME.match(h.name):
                runtime[e.correlation_id()] = (start, h.thread)
            if annotation and not h.name.startswith("bench."):
                spans.append(h)
    for start, end, e in kernels:
        launch, thread = runtime.get(e.correlation_id(), (None, 0))
        device.append(Interval(start, end, e.name(), thread, launch))
    return device, host, spans
