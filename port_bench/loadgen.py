"""The one traffic generator: a mix's JSON parameters and the seed become
a fixed list of requests (prompt text, image, answer length, due time,
sampling), built during set-up; the mix's arrival law then offers them to
the program through its entry and records what each request saw, on the
client's clock.

The arrival law and the entry are found by name, as files of their own:
``arrivals/<law>.py`` (``due`` gives the groups of requests and when each
is due; ``offer`` drives them) and ``entries/<entry>.py`` (``build`` puts
the program's public entry over an engine). A new law or entry is a new
file, and a mix names it.

Every seed gets the same multiset of sizes and arrivals, in another order:
group sizes, answer lengths and question lengths are fixed lists that the
seed permutes a block at a time, so the work of a window does not depend
on the seed. Images and text are drawn from the seed.

A mix file (``traffic/<mix>.json``) holds:
  arrivals   ``law`` (a file of ``arrivals/``) and that law's parameters
  entry      ``name`` (a file of ``entries/``) and the entry's settings
  engine     keyword settings of the engine
  system     "shared" (one ``system_tokens`` text for every request) or
             "distinct" (one a request)
  question   ``tokens``: a fixed list of question lengths in tokens
  answers    a fixed list of answer lengths in tokens (no stop rule ends
             a request before)
  sampling   optional: a fixed list of the program's sampling settings
             (``SamplingParams`` keywords), dealt out like the answers;
             greedy where absent. The check takes greedy requests only.
  images     how many distinct images the requests draw from
  warmup     the set-up's warm-up: group sizes and answer length
  check      how many requests, and at least how many tokens, the
             correctness check takes after the window
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGE_TAG = "<image>"
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", dtype=np.uint8)


def module(kind: str, name: str, root: str = None):
    """``<root or port_bench>/<kind>/<name>.py``, loaded by its path."""
    path = os.path.join(root or HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ByteIdTokenizer:
    """Bytes in (256 BOS, 257 EOS); ids out, spelled as "12,345": the
    program's text is then its token ids, which the check reads back."""

    bos_token_id = 256
    eos_token_id = 257

    class _Enc(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text: str):
        return self._Enc(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def render(system: str, question: str) -> str:
    """The qwen_2 chat template of FastVLM's released checkpoints, with
    one image before the question."""
    return (f"<|im_start|>system\n{system}<|im_end|>\n"
            f"<|im_start|>user\n{IMAGE_TAG}\n{question}<|im_end|>\n"
            f"<|im_start|>assistant\n")


def prompt_ids(prompt: str, image_tokens: int):
    """(ids with the image's slots expanded, index of its first slot), as
    the byte tokenizer and the LLaVA sentinel expansion give them."""
    before, after = prompt.split(IMAGE_TAG)
    ids = list(before.encode()) + [-1] * image_tokens + list(after.encode())
    return ids, len(before.encode())


def parse_ids(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t]


@dataclasses.dataclass
class Request:
    idx: int
    prompt: str
    image: int            # index into the plan's images
    max_new: int
    due: float = 0.0      # seconds after the window opens
    group: int = -1       # the arrival group (a burst) it came in
    sampling: dict = dataclasses.field(default_factory=dict)

    @property
    def greedy(self) -> bool:
        return not self.sampling.get("temperature")


@dataclasses.dataclass
class Plan:
    requests: List[Request]
    warmup: List[List[Request]]   # groups submitted together in set-up
    images: List[np.ndarray]


def _text(rng, n: int) -> str:
    return _LETTERS[rng.integers(0, len(_LETTERS), n)].tobytes().decode()


def _shuffled(rng, xs: Sequence) -> list:
    return [xs[i] for i in rng.permutation(len(xs))]


class _Dealer:
    """A fixed list dealt out in a new order each time it runs out."""

    def __init__(self, rng, xs: Sequence):
        self.rng, self.xs, self.left = rng, list(xs), []

    def __call__(self):
        if not self.left:
            self.left = _shuffled(self.rng, self.xs)
        return self.left.pop()


def build(mix: dict, cfg: dict, seed: int, seconds: float,
          root: str = None) -> Plan:
    """The requests of one run of ``seconds``: every group the mix's law
    makes due before the window closes."""
    rng = np.random.default_rng([int(seed), 1])
    side = cfg["vision"]["image_size"]
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
              for _ in range(mix["images"])]
    q_lens = mix["question"]["tokens"]
    shared = _text(rng, mix["system_tokens"]) \
        if mix["system"] == "shared" else None
    answer = _Dealer(rng, mix["answers"])
    question = _Dealer(rng, q_lens)
    sampling = _Dealer(rng, mix.get("sampling", [{}]))

    def make(idx, q_len, n_new, **kw):
        system = shared if shared is not None \
            else _text(rng, mix["system_tokens"])
        return Request(idx, render(system, _text(rng, q_len)),
                       int(rng.integers(len(images))), int(n_new), **kw)

    law = module("arrivals", mix["arrivals"]["law"], root)
    reqs: List[Request] = []
    for j, (due, n) in enumerate(law.due(mix["arrivals"], rng, seconds)):
        for _ in range(n):
            reqs.append(make(len(reqs), question(), answer(), due=due,
                             group=j, sampling=sampling()))

    # set-up: each group size the window meets, once with the shortest
    # questions and once padded to the longest (a batch pads to its longest
    # prompt), so no prompt bucket is first used inside the window
    warm = []
    w_new = mix["warmup"]["answer_tokens"]
    q_ends = [min(q_lens), max(q_lens)]
    for n in mix["warmup"]["groups"]:
        for q_last in q_ends:
            warm.append([make(-1, q_ends[0], w_new) for _ in range(n - 1)]
                        + [make(-1, q_last, w_new)])
    return Plan(reqs, warm, images)


# ------------------------------------------------------------------ offer


@dataclasses.dataclass
class Record:
    """What one request saw: host clock (time.perf_counter) at its due
    time, at its send, at each streamed update with the text then, and at
    its stream's close."""
    req: Request
    t_due: float
    t_send: float = 0.0
    updates: list = dataclasses.field(default_factory=list)
    t_close: Optional[float] = None
    error: Optional[str] = None


def consume(rec: Record, stream) -> None:
    try:
        ups = rec.updates
        for u in stream:
            if "error" in u:  # the scheduler's failure envelope
                rec.error = u["error"]
                continue
            ups.append((time.perf_counter(), u))
    except Exception as e:  # a failed request is recorded, not raised
        rec.error = repr(e)
    rec.t_close = time.perf_counter()


def offer_due(server, plan: Plan, t0: float, t1: float,
              workers: int = 32) -> List[Record]:
    """An open loop: this thread hands every request to a pool of waiting
    threads at its due time, whether or not earlier ones finished; the
    threads only submit and drain. Each record keeps the due time and the
    time it was sent, so the generator's lateness shows."""
    todo: "queue.Queue" = queue.Queue()
    records: List[Record] = []

    def worker():
        while True:
            rec = todo.get()
            if rec is None:
                return
            rec.t_send = time.perf_counter()
            consume(rec, server.stream(rec.req, plan.images))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(workers)]
    for th in threads:
        th.start()
    for r in plan.requests:
        due = t0 + r.due
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec = Record(r, due)
        records.append(rec)
        todo.put(rec)
    for _ in threads:
        todo.put(None)
    for th in threads:
        th.join(timeout=180)
    return records


def warm(server, plan: Plan) -> None:
    """Set-up: each warm-up group submitted together, drained before the
    next."""
    for group in plan.warmup:
        recs = [Record(r, 0.0) for r in group]
        threads = [threading.Thread(
            target=consume, args=(rec, server.stream(rec.req, plan.images)),
            daemon=True) for rec in recs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        for rec in recs:
            if rec.error or not rec.updates:
                raise RuntimeError(f"warm-up request failed: {rec.error}")
