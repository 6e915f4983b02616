"""What a ``--trace 1`` run records: spans that the benchmark puts around
its calls into the model's layers, and the device's activity from
``torch.profiler``.

The spans wrap ``models/vlm.py``'s module functions for the traced run
only (``Spans.install`` / ``uninstall``): the engine and the scheduler
look those functions up at each call, so every call goes through the
wrapper. A span waits for the device at its end, which costs nothing here:
the caller reads a token back right after each of these calls anyway.

  encode   ``vlm.encode_images``: the images the tower is given
  prefill  ``vlm.prefill`` and ``vlm.prefill_continue``: host time to the
           device's end; each row's tokens and image slot, the cached
           offset, whether images were given
  decode   ``vlm.decode_chunk``: host time to the device's end (what the
           host was doing, for the breakdown's idle gaps)
"""

from __future__ import annotations

import re
import time
from typing import List, Tuple

import torch


def _sync(t) -> None:
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Spans:
    def __init__(self):
        self.events: List[Tuple[str, float, float, dict]] = []
        self._saved = {}

    def install(self, vlm) -> None:
        ev = self.events
        orig = {n: getattr(vlm, n) for n in (
            "encode_images", "prefill", "prefill_continue", "decode_chunk")}
        self._saved = orig
        self._vlm = vlm

        def encode_images(params, cfg, images, *a, **kw):
            t = time.perf_counter()
            out = orig["encode_images"](params, cfg, images, *a, **kw)
            ev.append(("encode", t, t, {"images": int(images.shape[0])}))
            return out

        def prefiller(name):
            def call(params, cfg, images, ids, lens, starts, *a, **kw):
                t = time.perf_counter()
                out = orig[name](params, cfg, images, ids, lens, starts, *a,
                                 **kw)
                _sync(ids)
                t_end = time.perf_counter()
                offset = a[0] if name == "prefill_continue" else 0
                ev.append(("prefill", t, t_end,
                           {"lens": lens.tolist(), "starts": starts.tolist(),
                            "offset": int(offset),
                            "images": images is not None
                            or kw.get("vision_embeds") is not None}))
                return out
            return call

        def decode_chunk(params, cfg, last_tok, *a, **kw):
            t = time.perf_counter()
            out = orig["decode_chunk"](params, cfg, last_tok, *a, **kw)
            _sync(last_tok)
            ev.append(("decode", t, time.perf_counter(), {}))
            return out

        vlm.encode_images = encode_images
        vlm.prefill = prefiller("prefill")
        vlm.prefill_continue = prefiller("prefill_continue")
        vlm.decode_chunk = decode_chunk

    def uninstall(self) -> None:
        for n, f in self._saved.items():
            setattr(self._vlm, n, f)
        self._saved = {}

    def of(self, name: str, t0: float, t1: float):
        """The spans of ``name`` that started in [t0, t1)."""
        return [e for e in self.events if e[0] == name and t0 <= e[1] < t1]


def inside(kernels, spans):
    """The kernels that started inside one of the spans (each span ends
    with the device's end, so it holds every kernel its call launched)."""
    import bisect

    spans = sorted((s, e) for _, s, e, _ in spans)
    starts = [s for s, _ in spans]
    out = []
    for k in kernels:
        i = bisect.bisect_right(starts, k[1]) - 1
        if i >= 0 and k[1] <= spans[i][1]:
            out.append(k)
    return out


class DeviceTrace:
    """``torch.profiler`` over the traced window, CUDA activity only (the
    host side is in the spans). ``kernels``: (name, start, end) on the
    host's ``perf_counter`` clock, aligned by a marker kernel launched
    right after a synchronise at the start."""

    MARK = "spin_kernel"

    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []
        self.t_start = self.t_end = 0.0
        self._prof = None
        self._t_mark = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self._prof.__exit__(None, None, None)
        raw = []
        try:
            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    raw.append((e.name(), e.start_ns() * 1e-9,
                                e.duration_ns() * 1e-9))
        except AttributeError:  # an older profiler: parsed events
            for e in self._prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    raw.append((e.name, e.time_range.start * 1e-6,
                                e.time_range.elapsed_us() * 1e-6))
        self._prof = None
        marks = [s for n, s, _ in raw if self.MARK in n]
        shift = self._t_mark - min(marks) if marks else 0.0
        self.kernels = sorted(
            (n, s + shift, s + shift + d) for n, s, d in raw
            if self.MARK not in n)

    def matching(self, pattern: str) -> List[Tuple[str, float, float]]:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k[0])]


def short_name(name: str) -> str:
    return re.sub(r"[^\w:.\-]+", "_", name).strip("_")[:64]


def top_ops(kernels, t0: float, t1: float, n: int = 10) -> list:
    """The device operations that took most time in [t0, t1]."""
    total = {}
    for name, s, e in kernels:
        if e <= t0 or s >= t1:
            continue
        k = short_name(name)
        total[k] = total.get(k, 0.0) + (min(e, t1) - max(s, t0))
    return sorted(([k, v] for k, v in total.items()),
                  key=lambda kv: -kv[1])[:n]


def label_gap(mid: float, spans: Spans, records) -> str:
    """What the host was doing in the middle of an idle stretch."""
    for name, s, e, _ in spans.events:
        if s <= mid < e:
            return f"host in {name} call"
    if any(r.t_send <= mid and (r.t_close is None or mid < r.t_close)
           for r in records):
        return "host in scheduler or client, no device call"
    return "no request in flight"


def idle_gaps(kernels, t0: float, t1: float, spans: Spans, records,
              n: int = 10) -> list:
    from port_bench.stats import gaps

    found = gaps(clipped(kernels, t0, t1), t0, t1)
    found.sort(key=lambda g: g[0] - g[1])
    return [[label_gap((s + e) / 2, spans, records), e - s]
            for s, e in found[:n]]


def clipped(kernels, t0: float, t1: float):
    """The kernels' (start, end) intervals cut to [t0, t1]."""
    return [(max(s, t0), min(e, t1)) for _, s, e in kernels
            if e > t0 and s < t1]
