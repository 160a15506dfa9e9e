"""The traced run's reduction: torch.profiler over the window's first
seconds, its Chrome trace written to a temporary file (TMPDIR), read back
and deleted.

Device operations are the trace's kernels, copies and memsets.  A host
range is a `record_function` range on the host (the prover's stages and
the harness's job spans); a device range is the same range as the
profiler draws it on the device's timeline.  Times are seconds."""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "proverbench: window"
OUTSIDE = "outside every range"


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged: list, t0: float, t1: float) -> float:
    return sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in merged)


class Trace:
    def __init__(self, events: list):
        us = 1e-6
        win = [e for e in events if e.get("ph") == "X"
               and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.t0 = win[0]["ts"] * us
        self.t1 = self.t0 + win[0]["dur"] * us
        self.ops = []  # (start, end, name) inside the window
        self.host = []  # (start, end, name): host ranges
        self.device_ranges = []  # (start, end, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = e["ts"] * us
            end = s + e["dur"] * us
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                if self.t0 <= s < self.t1:
                    self.ops.append((s, end, e["name"]))
            elif cat == "user_annotation" and e["name"] != WINDOW:
                self.host.append((s, end, e["name"]))
            elif cat == "gpu_user_annotation":
                self.device_ranges.append((s, end, e["name"]))
        self.merged = _union([(s, min(e, self.t1)) for s, e, _ in self.ops])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged)

    def busy_in(self, names) -> float | None:
        """Device-busy seconds inside the device ranges of these names;
        None where the trace holds none of them."""
        spans = _union([(s, e) for s, e, n in self.device_ranges
                        if n in names])
        if not spans:
            return None
        return sum(_covered(self.merged, s, e) for s, e in spans)

    def _host_segments(self) -> list:
        """(start, end, name) of the innermost host range open, from the
        first range's start to the last one's end (ranges of one thread
        nest, so a sweep keeps the open ones in a stack)."""
        marks = sorted([(s, 1, i) for i, (s, _e, _n) in enumerate(self.host)]
                       + [(e, 0, i) for i, (_s, e, _n) in enumerate(self.host)])
        segs, open_ = [], []
        for (t, starts, i), nxt in zip(marks, marks[1:] + [None]):
            if starts:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            if nxt is not None and nxt[0] > t:
                name = self.host[open_[-1]][2] if open_ else OUTSIDE
                segs.append((t, nxt[0], name))
        return segs

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        device's idle time by what the host was doing: each stretch of a
        gap between device operations goes to the innermost host range
        open during it."""
        by_op: dict = {}
        for s, e, n in self.ops:
            by_op[n[:160]] = by_op.get(n[:160], 0.0) + (e - s)
        gaps, last = [], self.t0
        for s, e in self.merged + [[self.t1, self.t1]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        segs = self._host_segments()
        by_gap: dict = {}
        k = 0
        for g0, g1 in gaps:
            covered = 0.0
            while k < len(segs) and segs[k][1] <= g0:
                k += 1
            j = k
            while j < len(segs) and segs[j][0] < g1:
                s, e, name = segs[j]
                d = min(e, g1) - max(s, g0)
                if d > 0:
                    by_gap[name] = by_gap.get(name, 0.0) + d
                    covered += d
                j += 1
            rest = g1 - g0 - covered
            if rest > 1e-9:  # not inside any range, beyond rounding
                by_gap[OUTSIDE] = by_gap.get(OUTSIDE, 0.0) + rest
        order = lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_op), "idle_gaps": order(by_gap)}


class Profiler:
    """torch.profiler over the first part of a window: `stop()` when enough
    is traced, `read()` once the window has closed (the export and its
    reading take seconds for every hundred thousand device operations, so
    a long window is not traced whole)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.running = True

    def stop(self) -> None:
        import torch

        self._range.__exit__(None, None, None)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        # the profiler keeps a device record only if it falls inside its
        # window as the host's clock reads it: held open a moment longer
        time.sleep(1.0)
        self._prof.stop()
        self.running = False

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(events)
