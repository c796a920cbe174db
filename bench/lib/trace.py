"""The traced slice: ``torch.profiler`` over part of the window (the
pattern of ``tools/k3_trace.py``), reduced to the device's busy time, the
device time of each kernel by name and the longest idle gaps with what the
host was doing in them."""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Slice:
    """Start with ``start()`` and stop with ``stop()`` at points where the
    device is idle (after a sync); ``summary`` then holds the reduction."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.summary: dict | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = reduce_events(events)


def _union(spans: list) -> tuple[float, list]:
    """Busy time of sorted (start, end) spans and the gaps between them."""
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, gaps


def _host_at(host: list, t: float) -> str:
    """The innermost host event running at time t (µs), or 'host idle'."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, e, name)
    return best[2] if best else "host idle"


def reduce_events(events: list) -> dict:
    """Chrome-trace events → {busy_s, span_s, kernels: {name: [count, s]},
    gaps: [(what the host ran, s)] longest first}.  ``span_s`` runs from
    the first device operation's start to the last one's end."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e.get("name", "?")) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not dev:
        return {"busy_s": 0.0, "span_s": 0.0, "kernels": {}, "gaps": []}
    kernels: dict = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    busy, gaps = _union([(s, e) for s, e, _ in dev])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_at(host, (s + e) / 2), (e - s) * 1e-6)
             for s, e in gaps[:10]]
    return {"busy_s": busy * 1e-6, "span_s": (dev[-1][1] - dev[0][0]) * 1e-6,
            "kernels": kernels, "gaps": named}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])
    return {"device_ops": [[name, s] for name, (_, s) in ops[:10]],
            "idle_gaps": [[name, s] for name, s in summary["gaps"][:10]]}
