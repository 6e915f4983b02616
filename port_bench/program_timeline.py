"""Readings from the program's own timeline in a ``--trace 1`` run.

While the traced window's ``torch.profiler`` records, the port's serving
scheduler keeps a timeline of spans of its own
(``fastvlm_tpu_torch/timeline.py``): the gather, the batch's prepare, every
prefill with its tower and decoder parts on the device, the first tokens.
``timeline(ctx)`` finds the last such timeline, puts its device intervals
on the host's clock once (``Timeline.resolve``) and keeps it on the
context as ``ctx.program_timeline``; a context built with that attribute
set is read as it is. A program without the timeline gives None, and so
does every reading here.

Each reading returns None where the run holds nothing to read: no traced
window (``ctx.device``), no timeline, no span of its kind in the window,
no table of peaks for the device.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Tuple

from port_bench import flops, stats, trace

# device records that are copies or fills, not kernels
_NOT_KERNELS = re.compile(r"^(Memcpy|Memset)")


def timeline(ctx):
    """The program's resolved timeline of the traced window, or None."""
    if ctx.device is None:
        return None
    if not hasattr(ctx, "program_timeline"):
        ctx.program_timeline = _latest()
    return ctx.program_timeline


def _latest():
    try:
        from fastvlm_tpu_torch import timeline as program
    except ImportError:  # a program without a timeline of its own
        return None
    found = program.profiled()
    if not found:
        return None
    tl = found[-1]
    tl.resolve()
    return tl


def spans(ctx, name: str) -> List:
    """The closed spans of ``name`` that started in the window."""
    tl = timeline(ctx)
    if tl is None:
        return []
    return [s for s in tl.of(name)
            if s.t1 is not None and ctx.t0 <= s.t0 < ctx.t1]


def batch_prefills(ctx) -> List:
    """The window's gathered-batch prefills that carry a device interval,
    where the device trace holds records to read against them."""
    if ctx.device is None or not ctx.device.kernels:
        return []
    return [s for s in spans(ctx, "sched.prefill")
            if s.attrs.get("kind") == "batch" and s.device is not None]


def prep_ms(ctx) -> Optional[float]:
    """Mean host time of the window's ``sched.prepare`` spans, ms."""
    found = spans(ctx, "sched.prepare")
    if not found:
        return None
    return 1000.0 * sum(s.t1 - s.t0 for s in found) / len(found)


class _Records:
    """The device's records sorted by start, to take those that overlap an
    interval without a pass over the whole window."""

    def __init__(self, kernels):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.starts = [k[1] for k in self.kernels]
        self.longest = max((e - s for _, s, e in self.kernels), default=0.0)

    def overlapping(self, lo: float, hi: float) -> List[Tuple]:
        i = bisect.bisect_left(self.starts, lo - self.longest)
        j = bisect.bisect_right(self.starts, hi)
        return [k for k in self.kernels[i:j] if k[2] > lo and k[1] <= hi]


def prefill_launches(ctx) -> Optional[float]:
    """Mean number of kernels that started inside the device interval of
    each gathered batch's prefill (copies and fills not counted)."""
    found = batch_prefills(ctx)
    if not found:
        return None
    recs = _Records(k for k in ctx.device.kernels
                    if not _NOT_KERNELS.match(k[0]))
    n = sum(1 for s in found for _, ks, _ in recs.overlapping(*s.device)
            if ks >= s.device[0])
    return n / len(found)


def _bursts(ctx):
    """(start, end) of each burst of the window: its due time to its last
    request's first token, as ``readings.burst_idle_ms`` takes them."""
    out = {}
    for r in ctx.records:
        if r.updates and ctx.t0 <= r.t_due < ctx.t1:
            s, e = out.get(r.req.group, (r.t_due, r.t_due))
            out[r.req.group] = (s, max(e, r.updates[0][0]))
    return list(out.values())


def burst_idle_launch_ms(ctx) -> Optional[float]:
    """Mean over the window's bursts of the time inside the device
    intervals of their gathered batches' prefills in which the device ran
    nothing (it waited on launches, or on a host read inside the call),
    ms. A prefill belongs to the burst whose time holds its device start;
    each interval is cut to its burst's time."""
    bursts = _bursts(ctx)
    found = batch_prefills(ctx)
    if not bursts or not found:
        return None
    recs = _Records(ctx.device.kernels)
    idle = 0.0
    for s in found:
        ds, de = s.device
        for bs, be in bursts:
            if bs <= ds < be:
                lo, hi = ds, min(de, be)
                idle += (hi - lo) - stats.union_seconds(
                    trace.clipped(recs.overlapping(lo, hi), lo, hi))
                break
    return 1000.0 * idle / len(bursts)


def encode_mfu(ctx) -> Optional[float]:
    """The tower's and projector's operations for the real images of the
    window's prefills (rows with an image slot; padding rows count
    nothing) over the summed device intervals of their ``vlm.encode``
    spans at the bf16 peak, in %."""
    if ctx.peak is None:
        return None
    prefills = {s.id: s for s in spans(ctx, "sched.prefill")}
    work = seconds = 0.0
    for s in spans(ctx, "vlm.encode"):
        parent = prefills.get(s.parent)
        if parent is None or s.device is None:
            continue
        work += parent.attrs.get("images", 0) * (
            flops.tower_flops(ctx.cfg) + flops.projector_flops(ctx.cfg))
        seconds += s.device[1] - s.device[0]
    if work <= 0 or seconds <= 0:
        return None
    return 100.0 * work / (seconds * ctx.peak["bf16_flops"])
