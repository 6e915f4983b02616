"""Rank 0 driving the follower ranks of a tensor-parallel engine in lockstep.

JAX's tensor-parallel engine is one controller: GSPMD runs each device
call on every chip of the mesh. PyTorch runs one process a rank, so every
rank must make the same device calls in the same order. Rank 0 runs all
host logic (tokenizer, stop rules, the scheduler's gather window,
admission, resizing and spec tuning, HTTP) and, before each device call,
broadcasts the call's name and inputs over a CPU gloo group built beside
the mesh, so the message never waits on the card. The follower ranks
(``follow``) receive it and make the same call on their own pieces, until
rank 0 sends stop (``stop``).

The calls are a registry (``calls``: name -> function), the engine's
(``engine.Engine._device_calls``): the decoder's passes and the KV cache
constructors. A follower that receives a name outside it raises.

What crosses, and how:
  * a tensor held by one rank only: a KV cache's planes, whose kv heads
    differ from rank to rank. A call made with ``local=True`` (a cache
    constructor) registers every tensor of its result under a number; each
    rank keeps its own tensor under that number, and a later message names
    the number. Once rank 0's tensor is freed, the next message tells the
    followers to drop theirs. A view of such a tensor cannot cross
    (ValueError): its contents differ between ranks;
  * every other tensor by value, as a host copy (on the card a device read;
    rank 0 has usually just read the device for the tokens anyway), put on
    the follower's device;
  * a ``torch.Generator`` as its state: a follower draws what rank 0 draws;
  * dataclasses, named tuples, tuples, lists and dicts field by field;
    anything else pickled as it is.

A call that raises on a follower is logged and the follower goes on: rank
0 meets the same failure on the same inputs (a bad request) and goes on
serving. Every collective, the message broadcast included, fails after
the process group's timeout instead of hanging when a rank dies.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import threading
import weakref
from typing import Any, Callable, Dict, NamedTuple, Sequence

import torch
import torch.distributed as dist

from fastvlm_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT

logger = logging.getLogger(__name__)

STOP = "stop"


class _Handle(NamedTuple):
    n: int


class _Value(NamedTuple):
    t: torch.Tensor  # a host copy


class _Gen(NamedTuple):
    state: torch.Tensor


class Lockstep:
    """One rank's end of the channel: ``call`` on rank 0 (``ranks[0]``),
    ``follow`` on the others. ``device``: where a follower puts the tensors
    it receives. Every rank of the world constructs it, in the same order
    (it creates a process group)."""

    def __init__(self, calls: Dict[str, Callable], ranks: Sequence[int],
                 device, timeout: datetime.timedelta = DEFAULT_TIMEOUT):
        self.calls = calls
        self.src = int(ranks[0])
        self.device = torch.device(device)
        self.group = dist.new_group([int(r) for r in ranks], backend="gloo",
                                    timeout=timeout)
        self.leader = dist.get_rank() == self.src
        self._lock = threading.Lock()
        self._next = 0
        self._ids: Dict[int, int] = {}       # id(tensor) -> handle
        self._storages = collections.Counter()  # data_ptr -> local tensors
        self._table: Dict[int, torch.Tensor] = {}  # a follower's handles
        self._freed: collections.deque = collections.deque()

    # ---------------- rank 0 ----------------

    def call(self, name: str, args: tuple = (), kw: Dict[str, Any] = None,
             local: bool = False):
        """Send the call to the followers, then make it here; returns its
        result. ``local``: the result's tensors are rank-local (a cache
        constructor's)."""
        kw = kw or {}
        if name not in self.calls:
            raise ValueError(f"lockstep: unknown call {name!r}")
        with self._lock:
            memo: Dict[int, Any] = {}
            msg = (name, self._encode(args, memo), self._encode(kw, memo),
                   local, self._take_freed())
            dist.broadcast_object_list([msg], src=self.src, group=self.group)
            out = self.calls[name](*args, **kw)
            if local:
                self._register(out)
        return out

    def stop(self) -> None:
        """End every follower's ``follow``."""
        with self._lock:
            dist.broadcast_object_list(
                [(STOP, (), {}, False, self._take_freed())], src=self.src,
                group=self.group)

    def _take_freed(self):
        out = []
        while True:
            try:
                out.append(self._freed.popleft())
            except IndexError:
                return out

    def _encode(self, x, memo):
        if isinstance(x, torch.Tensor):
            key = id(x)
            if key not in memo:
                memo[key] = self._encode_tensor(x)
            return memo[key]
        if isinstance(x, torch.Generator):
            return _Gen(x.get_state())
        return _map(x, lambda v: self._encode(v, memo))

    def _encode_tensor(self, t: torch.Tensor):
        n = self._ids.get(id(t))
        if n is not None:
            return _Handle(n)
        ptr = t.untyped_storage().data_ptr()
        if ptr and self._storages[ptr]:
            raise ValueError("lockstep: a view of a rank-local tensor (a KV "
                             "cache's) cannot cross: its contents differ "
                             "between ranks")
        t = t.detach()
        return _Value(t.cpu() if t.device.type != "cpu" else t.clone())

    def _register(self, out) -> None:
        for t in _tensors(out):
            if id(t) in self._ids:
                continue
            n, key = self._next, id(t)
            self._next += 1
            self._ids[key] = n
            if self.leader:
                ptr = t.untyped_storage().data_ptr()
                self._storages[ptr] += 1
                weakref.finalize(t, self._release, key, n, ptr)
            else:
                self._table[n] = t

    def _release(self, key: int, n: int, ptr: int) -> None:
        """Rank 0's tensor ``n`` died: forget it, and let the next message
        free the followers' (runs in whichever thread freed it, so it takes
        no lock)."""
        self._ids.pop(key, None)
        self._storages[ptr] -= 1
        self._freed.append(n)

    # ---------------- followers ----------------

    def follow(self) -> None:
        """Receive and make rank 0's calls until it sends stop."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self.src, group=self.group)
            name, args, kw, local, freed = box[0]
            for n in freed:
                t = self._table.pop(n, None)
                if t is not None:
                    self._ids.pop(id(t), None)
            if name == STOP:
                return
            if name not in self.calls:
                raise ValueError(f"lockstep: unknown call {name!r} from "
                                 f"rank {self.src}")
            memo: Dict[int, Any] = {}
            try:
                out = self.calls[name](*self._decode(args, memo),
                                       **self._decode(kw, memo))
            except Exception:  # rank 0 fails alike and goes on serving
                logger.exception("lockstep call %s failed on this rank", name)
                continue
            if local:
                self._register(out)

    def _decode(self, x, memo):
        if isinstance(x, (_Handle, _Value, _Gen)):
            key = id(x)
            if key not in memo:
                if isinstance(x, _Handle):
                    memo[key] = self._table[x.n]
                elif isinstance(x, _Value):
                    memo[key] = x.t.to(self.device)
                else:
                    g = torch.Generator(device=self.device)
                    g.set_state(x.state)
                    memo[key] = g
            return memo[key]
        return _map(x, lambda v: self._decode(v, memo))


def _map(x, fn):
    """``x`` with ``fn`` applied to each field of a dataclass, named tuple,
    tuple, list or dict; anything else as it is."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: fn(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(fn(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(fn(v) for v in x)
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return x


def _tensors(x):
    """The tensors of ``x`` (through the containers ``_map`` walks), in
    order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
