"""The serving path's timeline: the scheduler's instant events and spans,
with the device interval of each span that launches work, on the host's
``time.perf_counter`` clock.

``BatchScheduler.trace`` holds one; None is off, and each site then costs
one ``None`` test (nothing is allocated, no CUDA event is made). Code below
the scheduler (``models/vlm.py``) finds it through ``current()``, which the
scheduler thread binds while its trace is on; every other thread, and the
follower ranks of a tensor-parallel engine, see None and record nothing.

A timeline keeps
  * the scheduler's instant events ``(t, event, *detail)`` (``append``;
    iterating a timeline yields them, as the list it replaces did);
  * spans (``open`` / ``close``): a name, an id, the parent (the span open
    on this timeline when it opened), the ids of the requests it serves,
    host start and end, a few attributes and, for ``device=True`` on a CUDA
    device, two timing events recorded on the current stream at its start
    and end, with no synchronise.

``resolve()`` puts those device intervals on the host clock once the work
is done: an event's time after an anchor event, recorded right after a
``torch.cuda.synchronize()`` when the timeline was made, scaled by the
host's over the device's time between that anchor and a second one
recorded at the first ``resolve()`` (``drift_s``: how far the device's
clock ran ahead of the host's between the two).

The serving path's spans:

  sched.gather       the first request in hand -> the batch closed
                     (requests: the batch's)
  sched.prepare      the gather closed -> before the prefill's first
                     launch: each engine.prepare (image upload and
                     rescale), the ids read back, pages mapped, prefix
                     reuse, padding, the image stack (rows, padded)
  engine.prepare     one request's ``Engine.prepare`` in sched.prepare
  sched.prefill      every prefill the scheduler dispatches, from dispatch
                     to the host read of its tokens; device interval (kind:
                     "batch" a gathered batch, "admit" an admission,
                     "chunk" an admission chunk; rows, padded, tokens past
                     the cached offset, cached, images of the real rows)
  vlm.encode         the tower and projector inside a prefill; device
                     interval (images: the stack, padding rows included)
  vlm.decoder        the decoder's forward through the logits inside a
                     prefill; device interval
  sched.first_token  after a gathered batch's host read: the prefix
                     published and each row's first update pushed

While ``torch.profiler`` records, a scheduler whose trace is off keeps a
timeline of its own (``follows_profiler``) and drops it once the profiler
has stopped, so a profile of the serving path can be read against these
spans; ``profiled()`` hands out the last few such timelines to code that
holds the profile but not the scheduler.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    name: str
    id: int
    parent: Optional[int]
    requests: Tuple[int, ...]
    t0: float
    t1: Optional[float] = None  # None: never closed (its call raised)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # (start, end) on the host clock, once resolved
    device: Optional[Tuple[float, float]] = None
    events: Optional[list] = None  # the timing events at start and end


class Timeline:
    def __init__(self, device=None, *,
                 timer: Optional[Callable[[], Any]] = None,
                 follows_profiler: bool = False):
        """``device``: the engine's; on a CUDA device, spans opened with
        ``device=True`` carry device intervals. ``timer`` makes a timing
        event (``record()``, ``synchronize()``, ``query()``,
        ``elapsed_time(other)`` in ms) in place of a CUDA event: a clock
        to test the arithmetic with. ``follows_profiler``: opened by a
        scheduler while ``torch.profiler`` records (module docstring); it
        is listed in ``profiled()``."""
        self.events: List[tuple] = []
        self.spans: List[Span] = []
        self._open: List[Span] = []
        self.follows_profiler = follows_profiler
        self._cuda = None
        if device is not None and torch.device(device).type == "cuda":
            self._cuda = torch.device(device)
            if timer is None:
                timer = _cuda_event
        self._timer = timer
        self._anchors: List[Tuple[float, Any]] = []
        self.drift_s: Optional[float] = None
        self.anchor_span_s: Optional[float] = None
        if timer is not None:
            self._anchors.append(self._anchor())
        if follows_profiler:
            _PROFILED.append(self)

    # ------------- instant events -------------

    def append(self, event: tuple) -> None:
        self.events.append(event)

    def __iter__(self):
        return iter(list(self.events))

    # ------------- spans -------------

    def open(self, name: str, *, requests: Sequence[int] = (),
             device: bool = False, **attrs) -> Span:
        """A span starting now, whose parent is the span open here."""
        sp = Span(name, len(self.spans),
                  self._open[-1].id if self._open else None,
                  tuple(requests), time.perf_counter(), attrs=attrs)
        if device and self._timer is not None:
            ev = self._timer()
            ev.record()
            sp.events = [ev]
        self.spans.append(sp)
        self._open.append(sp)
        return sp

    def close(self, sp: Span, *, requests: Optional[Sequence[int]] = None,
              **attrs) -> None:
        """End ``sp`` now, adding ``attrs``; spans opened inside it and
        left open (their call raised) leave the stack with it."""
        if sp.events is not None:
            ev = self._timer()
            ev.record()
            sp.events.append(ev)
        sp.t1 = time.perf_counter()
        if requests is not None:
            sp.requests = tuple(requests)
        sp.attrs.update(attrs)
        if sp in self._open:
            del self._open[self._open.index(sp):]

    def unwind(self) -> None:
        """Forget the spans still open (their calls raised): the next span
        has no parent."""
        self._open.clear()

    def of(self, name: str) -> List[Span]:
        return [s for s in list(self.spans) if s.name == name]

    # ------------- device intervals -------------

    def _anchor(self) -> Tuple[float, Any]:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)
        ev = self._timer()
        t = time.perf_counter()
        ev.record()
        return t, ev

    def resolve(self) -> None:
        """Put the device interval of every span whose work is done on the
        host clock (waits for the device once). A timeline without timing
        events has nothing to resolve."""
        if not self._anchors:
            return
        if len(self._anchors) == 1:
            self._anchors.append(self._anchor())
        (ha, ea), (hb, eb) = self._anchors
        eb.synchronize()
        dev_s = ea.elapsed_time(eb) / 1e3
        host_s = hb - ha
        self.drift_s, self.anchor_span_s = dev_s - host_s, host_s
        scale = host_s / dev_s if dev_s > 0 else 1.0
        for sp in list(self.spans):
            if sp.events is None or len(sp.events) < 2 \
                    or not sp.events[1].query():
                continue
            s, e = (ha + ea.elapsed_time(ev) / 1e3 * scale
                    for ev in sp.events)
            sp.device = (s, e)


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


# ------------- the timeline a thread records into -------------


class _Bound(threading.local):
    timeline: Optional[Timeline] = None


_bound = _Bound()


def current() -> Optional[Timeline]:
    """The timeline this thread records into, or None."""
    return _bound.timeline


def bind(tl: Optional[Timeline]) -> None:
    _bound.timeline = tl


# ------------- following torch.profiler -------------

_PROFILED: "collections.deque[Timeline]" = collections.deque(maxlen=4)


def profiler_on() -> bool:
    """Whether ``torch.profiler`` is recording in this process."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def profiled() -> List[Timeline]:
    """The last timelines that schedulers kept while a profiler recorded,
    oldest first."""
    return list(_PROFILED)
