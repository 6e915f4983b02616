"""Readings that several per-layer metrics share. Each takes the run's
``harness.Ctx`` and returns a number, or None where the run holds nothing
to read (no traced window, no matching call or kernel, no table of peaks
for the device): a share of a roofline or a peak is never reported as 0.
"""

from __future__ import annotations

from typing import Optional

from port_bench import family, flops, stats, trace

# kernel names of the program's hand-written kernel K1 (csrc/ffn.cu)
K1 = r"\bffn_\w*kernel"


def cached_share(ctx) -> Optional[float]:
    """Prompt tokens the prefix cache served, as a share of all prompt
    tokens, over the window's requests (the scheduler's update stats)."""
    cached = total = 0
    for r in ctx.records:
        if not r.updates:
            continue
        cached += int(r.updates[-1][1]["stats"].get("cached_tokens", 0))
        total += ctx.prompt_tokens(r)
    return 100.0 * cached / total if total else None


def _spans(ctx, name):
    """The traced spans of ``name`` that started in the window."""
    if ctx.device is None or ctx.spans is None:
        return []
    return ctx.spans.of(name, ctx.t0, ctx.t1)


def _kernel_s(ctx, pattern, spans) -> float:
    """Time of the kernels matching ``pattern`` that the spans' calls
    launched."""
    return sum(e - s for _, s, e in trace.inside(ctx.device.matching(pattern),
                                                  spans))


def prefill_mfu(ctx) -> Optional[float]:
    """Model operations of the window's prefill calls (the tower and
    projector for each row with an image, the decoder over each row's
    tokens past the cached offset) over those calls' wall time at the bf16
    peak, in %. Padding rows (one token, no image) count nothing; the
    decoder's count is its family's."""
    spans = _spans(ctx, "prefill")
    if not spans or ctx.peak is None:
        return None
    work = wall = 0.0
    decoder = family.of(ctx.cfg).flops
    for _, s, e, info in spans:
        wall += e - s
        for n, at in zip(info["lens"], info["starts"]):
            if at >= 0 and info["images"]:
                work += flops.tower_flops(ctx.cfg) \
                    + flops.projector_flops(ctx.cfg)
            if at >= 0 or n > 1:
                work += decoder(ctx.cfg, n, info["offset"])
    return 100.0 * work / (wall * ctx.peak["bf16_flops"])


def k1_roofline(ctx) -> Optional[float]:
    """Σ K1 bound time of the tower passes of the window's prefill calls
    over the time of the K1 kernels those calls launched, in %."""
    prefills = _spans(ctx, "prefill")
    if not prefills or ctx.peak is None:
        return None
    kernel = _kernel_s(ctx, K1, prefills)
    if kernel <= 0:
        return None
    encodes = [x for x in trace.inside(
        [(n, s, e) for n, s, e, _ in ctx.spans.events if n == "encode"],
        prefills)]
    images = {(s, e): info["images"] for n, s, e, info in ctx.spans.events
              if n == "encode"}
    bound = sum(flops.k1_encode_bound_s(ctx.cfg, images[(s, e)], ctx.peak)
                for _, s, e in encodes)
    return 100.0 * bound / kernel


def busy_s(ctx) -> float:
    """Seconds of the window in which an operation ran on the device."""
    return stats.union_seconds(trace.clipped(ctx.device.kernels, ctx.t0,
                                             ctx.t1))


def burst_idle_ms(ctx) -> Optional[float]:
    """Mean over the window's bursts of the time in which no operation ran
    on the device between the burst's due time and the first token of its
    last request, ms: the part of a burst's time to first token that the
    device spent waiting on the host."""
    if ctx.device is None:
        return None
    bursts = {}
    for r in ctx.records:
        if r.updates and ctx.t0 <= r.t_due < ctx.t1:
            s, e = bursts.get(r.req.group, (r.t_due, r.t_due))
            bursts[r.req.group] = (s, max(e, r.updates[0][0]))
    if not bursts:
        return None
    idle = sum((e - s) - stats.union_seconds(
        trace.clipped(ctx.device.kernels, s, e)) for s, e in bursts.values())
    return 1000.0 * idle / len(bursts)
