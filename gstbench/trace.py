"""The traced run's instruments: ``torch.profiler`` over the window, the
benchmark's own spans around its calls into the program, and a record of
each fused-kernel call's operations and compulsory bytes.

From the trace: the device's busy time (the union of every kernel, copy and
set on the card), the device operations that took most time, and the idle
gaps between them by what the host was doing (the innermost benchmark span
and the innermost host operation open when the gap began).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from gstbench import peaks

SPAN = "gstbench:"
TOP = 10
NAME_CHARS = 160  # a kernel's demangled name, cut


class KernelCalls:
    """While installed, wraps ``gstx_torch.kernels.ffn.fused_ffn`` and
    ``fused_dense_ln`` (the layers look them up at call time) and sums,
    by kernel, each call's least time (from its operations and compulsory
    bytes) and the calls."""

    def __init__(self):
        self.least_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._saved = None

    def _record(self, kind, flops, nbytes):
        self.least_s[kind] += peaks.least_seconds(flops, nbytes)
        self.calls[kind] += 1

    def install(self):
        from gstx_torch.kernels import ffn as kffn

        ffn, dense_ln = kffn.fused_ffn, kffn.fused_dense_ln
        self._saved = (kffn, ffn, dense_ln)

        def fused_ffn(x, w1, b1, w2, b2, gamma, beta, eps=1e-12):
            m = x.numel() // x.shape[-1]
            self._record("fused_ffn", peaks.ffn_flops(m, w1.shape[1],
                                                      w1.shape[0]),
                         peaks.ffn_bytes(x, w1, b1, w2, b2, gamma, beta))
            return ffn(x, w1, b1, w2, b2, gamma, beta, eps)

        def fused_dense_ln(x, weight, bias, residual, gamma, beta,
                           eps=1e-12):
            m = residual.numel() // residual.shape[-1]
            self._record("fused_dense_ln",
                         peaks.dense_ln_flops(m, weight.shape[1],
                                              weight.shape[0]),
                         peaks.dense_ln_bytes(x, weight, bias, residual,
                                              gamma, beta))
            return dense_ln(x, weight, bias, residual, gamma, beta, eps)

        kffn.fused_ffn, kffn.fused_dense_ln = fused_ffn, fused_dense_ln

    def remove(self):
        if self._saved is not None:
            kffn, ffn, dense_ln = self._saved
            kffn.fused_ffn, kffn.fused_dense_ln = ffn, dense_ln
            self._saved = None


def span(name: str):
    """A named host span of the benchmark (costs next to nothing when no
    profiler runs)."""
    return torch.profiler.record_function(SPAN + name)


class Tracer:
    """``start()`` / ``stop()`` around the traced window; ``summary`` then
    holds what the per-layer readers and the breakdown read."""

    def __init__(self, device):
        self.device = device
        self.kernels = KernelCalls()
        self.prof = None
        self.window_s: Optional[float] = None
        self.summary: Dict = {}

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.kernels.install()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = span("window")
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self):
        """Ends the traced window (its length is read first), then reads
        the trace."""
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.kernels.remove()
        self.summary = summarize(self.prof, self.window_s)
        self.prof = None


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def summarize(prof, window_s: float) -> Dict:
    """Busy seconds, device time and launches by operation name, and the
    idle gaps of the traced window by the host's activity."""
    host, dev = [], []
    bounds, main = None, None
    for e in _events(prof):
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; not the spans' device-side copies
            # nor the synchronisation records
            if not name.startswith(SPAN) and "Sync" not in name \
                    and "Wait" not in name:
                dev.append((start, end, name))
            continue
        if name == SPAN + "window":
            bounds, main = (start, end), e.start_thread_id()
        host.append((start, end, name, e.start_thread_id()))
    if bounds is None:
        bounds = (min(h[0] for h in host), max(h[1] for h in host))
    lo, hi = bounds
    by_name, counts = defaultdict(float), defaultdict(int)
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
        counts[n] += 1
    merged: List[List[int]] = []
    for s, e, _ in sorted(dev):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) / 1e9
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    main_host = [h[:3] for h in host if main is None or h[3] == main]
    # an event and its first child may start together: the outer first
    order = lambda h: (h[0], -h[1])  # noqa: E731
    spans = sorted((h for h in main_host
                    if h[2].startswith(SPAN) and h[2] != SPAN + "window"),
                   key=order)
    ops = sorted((h for h in main_host if not h[2].startswith(SPAN)),
                 key=order)
    labels = zip(_innermost(gaps, spans), _innermost(gaps, ops))
    idle = defaultdict(float)
    for (g0, g1), (sp, op) in zip(gaps, labels):
        sp = sp[len(SPAN):] if sp else "none"
        idle[f"{sp} / {op or 'no host op'}"] += (g1 - g0) / 1e9
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": by_name, "device_counts": counts,
            "idle_by_host": idle}


def _innermost(gaps, events):
    """For each gap (in time order), the name of the innermost of
    ``events`` (one thread's, so properly nested, sorted by start) open
    at the gap's start, or None: a sweep with a stack of open events."""
    out, stack, i = [], [], 0
    for g0, _ in gaps:
        while i < len(events) and events[i][0] <= g0:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown(summary: Dict) -> Dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, each at most TOP
    entries, seconds as measured."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(summary["device_ops"]),
            "idle_gaps": top(summary["idle_by_host"])}
