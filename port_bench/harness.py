"""One run of one cell: set-up, the measured window, the traced window's
readings, and the check that decides ``correct``.

The cell, its configuration and its traffic are found by name from
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<mix>.json`` (whose
arrival law and entry are ``arrivals/<law>.py`` and ``entries/<entry>.py``)
and, for each per-layer metric, ``metrics/<metric>.py``, whose
``read(ctx)`` returns the number or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from port_bench import family, flops, loadgen, readings, stats, trace, weights
from port_bench.reference import gaps

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fastvlm_tpu")
DRAIN_S = 60.0


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


REPO = os.path.dirname(HERE)


def load_cell(bench: dict, name: str, traffic_dir: str = None):
    """(workload entry, configuration dict, traffic dict) of cell ``name``:
    the configuration's ``file`` (a path from the checkout's root) and
    ``traffic/<mix>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(REPO, entry["file"]))
    mix = load_json(os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                                 cell["traffic"] + ".json"))
    return cell, cfg, mix


def metric_reader(name: str, metrics_dir: str = None):
    """The ``read`` function of ``metrics/<name>.py``."""
    root = os.path.dirname(metrics_dir) if metrics_dir else None
    return loadgen.module("metrics", name, root).read


def cell_metrics(bench: dict, cell: dict, kind: str) -> List[dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics:
    those that list the cell, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ------------------------------------------------------------- the program


def port_config(cfg: dict, dtype: str = "bfloat16"):
    """The port's FastVLMConfig for a configuration file; the decoder's is
    the port's own reading of the file (its ``model_type`` family, its
    window)."""
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.models import builder

    v = cfg["vision"]
    vision = C.FastViTConfig(
        layers=tuple(v["layers"]), embed_dims=tuple(v["embed_dims"]),
        mlp_ratios=(v["mlp_ratio"],) * len(v["layers"]),
        token_mixers=tuple(v["token_mixers"]), pos_embs=tuple(v["pos_embs"]),
        pos_emb_kernel=v["pos_emb_kernel"],
        repmixer_kernel=v["repmixer_kernel"], ffn_kernel=v["ffn_kernel"],
        down_patch_size=v["down_patch_size"], down_stride=v["down_stride"],
        cls_ratio=v["cls_ratio"], attn_head_dim=v["attn_head_dim"],
        se_rd_ratio=v["se_rd_ratio"], ln_eps=v["ln_eps"],
        image_size=v["image_size"], param_dtype=dtype, compute_dtype=dtype)
    decoder = builder.build_decoder_config(cfg, param_dtype=dtype,
                                           compute_dtype=dtype)
    return C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(projector_type=cfg["mm_projector_type"],
                                    mm_hidden_size=cfg["mm_hidden_size"],
                                    hidden_size=decoder.hidden_size),
        image_aspect_ratio=cfg["image_aspect_ratio"],
        mm_patch_merge_type=cfg["mm_patch_merge_type"])


def build_engine(cfg: dict, mix: dict, tree: dict, dtype: str):
    """The program as a deployment sets it up: the decoder's products
    fused, and the engine (which folds the tower's layer scales)."""
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import qwen2

    pcfg = port_config(cfg, dtype)
    params = {"vision": tree["vision"], "projector": tree["projector"],
              "decoder": qwen2.fuse_decoder_params(tree["decoder"],
                                                   pcfg.decoder)}
    # no sampled id is negative: no stop rule ends a request before its
    # drawn answer length
    return Engine(pcfg, params, loadgen.ByteIdTokenizer(), eos_ids=(-1,),
                  **mix.get("engine", {}))


def build_server(cfg: dict, mix: dict, tree: dict, dtype: str):
    """The engine, and the mix's entry over it (``entries/<name>.py``)."""
    entry = dict(mix["entry"])
    return loadgen.module("entries", entry.pop("name")).build(
        build_engine(cfg, mix, tree, dtype), entry)


# ---------------------------------------------------------------- context


class Ctx:
    """What a metric reader reads: the cell, its configuration and mix,
    the window's request records, and in a traced run the spans and the
    device's kernels."""

    def __init__(self, cell, cfg, mix, records, t0, t1, device_kind,
                 spans=None, device=None):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.records = records
        self.t0, self.t1 = t0, t1
        self.device_kind = device_kind
        self.peak = flops.peaks(device_kind)
        self.spans = spans
        self.device = device

    @staticmethod
    def served(rec) -> List[int]:
        return loadgen.parse_ids(rec.updates[-1][1]["text"]) \
            if rec.updates else []

    def prompt_tokens(self, rec) -> int:
        ids, _ = loadgen.prompt_ids(rec.req.prompt, flops.image_tokens(self.cfg))
        return len(ids)


# ------------------------------------------------------------------ check


def sample_for_check(records, mix: dict, seed: int) -> list:
    """Finished greedy requests of the window for the check: the longest,
    then others drawn from the seed until the count and the tokens are
    reached."""
    done = [r for r in records if r.error is None and r.updates
            and r.req.greedy]
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 2])
    want_n, want_tok = mix["check"]["requests"], mix["check"]["tokens"]
    longest = max(done, key=lambda r: (r.req.max_new, -r.req.idx))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    picked, tok = [longest], longest.req.max_new
    for r in rest:
        if len(picked) >= want_n and tok >= want_tok:
            break
        picked.append(r)
        tok += r.req.max_new
    return picked


def teacher_force(ref, cfg: dict, rec, tokens, images, device):
    """The reference's f32 logits at the positions that chose each of
    ``tokens``, with the request's prompt and ``tokens`` as its context."""
    ids, at = loadgen.prompt_ids(rec.req.prompt, flops.image_tokens(cfg))
    seq = ids + list(tokens[:-1])
    rows = list(range(len(ids) - 1, len(seq)))
    img = torch.as_tensor(images[rec.req.image], device=device)
    return ref.logits(seq, img, at, rows)


def numbers(per_request: List[List[float]]) -> Dict[str, float]:
    """The check's numbers from each request's gaps (by how much each
    served token's reference logit lies below the reference's best):
    the mean over all served tokens, the worst request's mean, the widest
    single gap. A configuration's ``check`` names those it holds."""
    flat = [g for r in per_request for g in r]
    return {"mean_logit_gap": sum(flat) / max(len(flat), 1),
            "worst_request_gap": max((sum(r) / len(r) for r in per_request
                                      if r), default=0.0),
            "max_logit_gap": max(flat, default=0.0),
            "tokens_checked": len(flat),
            "requests_checked": len(per_request)}


def check(cfg: dict, seed: int, sample, images, device, dtype):
    """Teacher-force each sampled request's prompt and served tokens
    through the reference of the configuration's decoder family (weights
    drawn again from the seed): the numbers of ``numbers``."""
    ref = family.of(cfg).Reference(cfg, weights.draw(cfg, seed, device,
                                                     dtype))
    per_request = []
    with torch.inference_mode():
        for rec in sample:
            served = Ctx.served(rec)
            want = teacher_force(ref, cfg, rec, served, images, device)
            per_request.append(gaps(want, served))
            del want
    return numbers(per_request)


# -------------------------------------------------------------------- run


@dataclasses.dataclass
class Served:
    """A run up to its check: the result line without ``correct`` and the
    limits, and what the check reads; the program is freed."""
    out: Dict[str, Any]
    cfg: dict
    mix: dict
    plan: Any
    sample: list
    device: Any
    dtype: Any


def serve(bench: dict, name: str, seed: int, seconds: float, trace_on: bool,
          *, t_process: float, device: str = "cuda", traffic_dir: str = None,
          log=print) -> Served:
    """Set-up, the window, the readings; then the program's state goes."""
    from fastvlm_tpu_torch.models import vlm

    cell, cfg, mix = load_cell(bench, name, traffic_dir)
    dev = torch.device(device)
    dtype = cfg["torch_dtype"]
    plan = loadgen.build(mix, cfg, seed, seconds)
    law = loadgen.module("arrivals", mix["arrivals"]["law"])
    log(f"{time.perf_counter() - t_process:.3f} s: requests and images")
    tree = weights.draw(cfg, seed, dev, getattr(torch, dtype))
    server = build_server(cfg, mix, tree, dtype)
    del tree
    log(f"{time.perf_counter() - t_process:.3f} s: weights and program")
    n_img = flops.image_tokens(cfg)
    longest = max(len(loadgen.prompt_ids(r.prompt, n_img)[0])
                  for r in plan.requests)
    server.warm(longest, max(mix["answers"]))
    log(f"{time.perf_counter() - t_process:.3f} s: the entry's warm-up")
    loadgen.warm(server, plan)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s: {len(plan.requests)} requests planned, "
        f"{len(plan.images)} images")

    spans = dtrace = None
    gc.collect()
    gc.freeze()
    if trace_on:
        spans = trace.Spans()
        spans.install(vlm)
        if dev.type == "cuda":
            dtrace = trace.DeviceTrace()
            dtrace.start()
    t0 = time.perf_counter() + 0.01
    t1 = t0 + seconds
    records = law.offer(server, plan, t0, t1)
    deadline = time.perf_counter() + DRAIN_S
    while any(r.t_close is None for r in records) and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    if dtrace is not None:
        dtrace.stop()
    if spans is not None:
        spans.uninstall()
    gc.unfreeze()

    log(f"entry counters {server.counters()}")
    late = [r.t_send - r.t_due for r in records if r.t_send]
    if late:
        log(f"requests sent at most {1000 * max(late):.3f} ms after due")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak_bytes = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    ctx = Ctx(cell, cfg, mix, records, t0, t1, kind, spans, dtrace)

    failed = [r for r in records
              if r.error is not None or r.t_close is None
              or len(Ctx.served(r)) != r.req.max_new]
    metrics: Dict[str, Any] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": peak_bytes}
    out = {"attempted": len(records), "failed": len(failed),
           "metrics": metrics, "device": device_info}
    if not trace_on:
        e2e = end_to_end(ctx, setup_s, log)
        for m in cell_metrics(bench, cell, "end_to_end"):
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "per_layer"):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace is not None:
            device_info["busy_s"] = readings.busy_s(ctx)
            device_info["window_s"] = t1 - t0
            out["breakdown"] = {
                "device_ops": trace.top_ops(dtrace.kernels, t0, t1),
                "idle_gaps": trace.idle_gaps(dtrace.kernels, t0, t1, spans,
                                             records)}

    sample = sample_for_check(records, mix, seed)
    # the program's state goes before the reference runs
    server.close()
    del server, ctx, spans, dtrace
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Served(out, cfg, mix, plan, sample, dev, getattr(torch, dtype))


def judge(s: Served, seed: int, log=print) -> Dict[str, Any]:
    """The check, and the result line: ``correct`` where every request of
    the window finished with its full answer and every number the
    configuration's ``check`` names is at or under its limit."""
    t_check = time.perf_counter()
    got = check(s.cfg, seed, s.sample, s.plan.images, s.device, s.dtype)
    log(f"check of {got['requests_checked']} requests, "
        f"{got['tokens_checked']} tokens, in "
        f"{time.perf_counter() - t_check:.3f} s; worst request's mean gap "
        f"{got['worst_request_gap']!r}, widest gap {got['max_logit_gap']!r}")
    limits = {k: {"value": got[k], "limit": lim}
              for k, lim in s.cfg["check"].items()}
    limits["failed_requests"] = {"value": s.out["failed"], "limit": 0}
    correct = bool(s.sample) and all(v["value"] <= v["limit"]
                                     for v in limits.values())
    out = {"correct": correct, **s.out}
    out["limits"] = limits
    return out


def run(bench: dict, name: str, seed: int, seconds: float, trace_on: bool,
        *, t_process: float, device: str = "cuda", traffic_dir: str = None,
        log=print) -> Dict[str, Any]:
    """One run; returns the result line's object."""
    return judge(serve(bench, name, seed, seconds, trace_on,
                       t_process=t_process, device=device,
                       traffic_dir=traffic_dir, log=log), seed, log)


def end_to_end(ctx: Ctx, setup_s: float, log=print) -> Dict[str, float]:
    """Every end-to-end metric this harness knows, over the window; the
    caller keeps the cell's."""
    out = {"setup_s": setup_s}
    ttft = [r.updates[0][0] - r.t_due for r in ctx.records if r.updates]
    if ttft:
        log(f"TTFT of {len(ttft)} requests, {stats.beyond(ttft, 95)} beyond "
            f"the 95th percentile")
        out["ttft_p95_ms"] = 1000 * stats.percentile(ttft, 95)
    return out
