"""The check that decides ``correct`` fails where it should, at a size a
test run holds (a tiny FastVLM on the CPU, bf16), in both burst cells:
the control (the reference in fp8 put in the program's place) and one
request's answer altered read above the limit, and a run whose timed
path is broken underneath comes out not correct, for each fault a serving
cell can have, one batch row's tokens altered among them. The same run of
the unbroken program comes out correct."""

import os
import time

import pytest
import torch

from port_bench import control, harness

DATA = os.path.join(os.path.dirname(__file__), "data")
CELLS = ("vqa-shared", "vqa-unshared")
SEED = 20260101


def bench():
    real = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    return {"configs": [{"name": "tiny",
                         "file": "port_bench/tests/data/tiny.json"}],
            "workloads": [{"name": f"tiny.{c}", "config": "tiny",
                           "traffic": f"tiny-{c}", "chips": 1}
                          for c in CELLS],
            "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                           for m in real["end_to_end"]],
            "per_layer": []}


def serve(cell, seed=SEED):
    torch.set_num_threads(2)
    return harness.serve(bench(), f"tiny.{cell}", seed, 3.0, False,
                         t_process=time.perf_counter(), device="cpu",
                         traffic_dir=os.path.join(DATA, "traffic"),
                         log=lambda m: None)


def run(cell, seed=SEED):
    return harness.judge(serve(cell, seed), seed, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_and_altered_fail(cell):
    s = serve(cell)
    got = control.readings(s, SEED)
    limits = got["limits"]
    assert set(limits) == {"mean_logit_gap"}
    lim = limits["mean_logit_gap"]
    assert got["program"]["mean_logit_gap"] <= lim, got
    assert got["control"]["mean_logit_gap"] > lim, got
    assert got["altered"]["mean_logit_gap"] > lim, got
    # the worst request's mean separates an altered answer further still
    assert got["altered"]["worst_request_gap"] > \
        10 * got["program"]["worst_request_gap"], got
    out = harness.judge(s, SEED, log=lambda m: None)
    assert out["correct"], out["limits"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "limits"
    assert out["limits"]["mean_logit_gap"]["value"] == pytest.approx(
        got["program"]["mean_logit_gap"])


def _skip_ffn(monkeypatch):
    """The tower's ConvFFN (kernel K1's call) returns its input: a step
    that leaves its state unchanged."""
    from fastvlm_tpu_torch.models import fastvit

    monkeypatch.setattr(fastvit, "ffn_block_apply",
                        lambda t, x, p, ls=None: x)


def _drop_kv_writes(monkeypatch):
    """A decode step writes nothing into the KV cache: the cache is
    returned as it came."""
    from fastvlm_tpu_torch.models import qwen2

    paged = qwen2.write_paged
    monkeypatch.setattr(qwen2, "write_token", lambda *a, **kw: None)
    monkeypatch.setattr(
        qwen2, "write_paged",
        lambda ck, cv, k, v, dest: None if k.shape[1] == 1
        else paged(ck, cv, k, v, dest))


def _alter_tokens(monkeypatch):
    """Each decoded token is altered where it is sampled."""
    from fastvlm_tpu_torch.models import vlm

    for name in ("sample", "sample_rows"):
        orig = getattr(vlm, name)
        monkeypatch.setattr(vlm, name, lambda g, logits, s, _o=orig: (
            _o(g, logits, s) + 1) % logits.shape[-1])


def _alter_one_row(monkeypatch):
    """In a batched decode step, the second row's token is altered where
    it is sampled; every other row is served as it should be."""
    from fastvlm_tpu_torch.models import vlm

    orig = vlm.sample_rows

    def sample_rows(g, logits, s):
        out = orig(g, logits, s)
        if out.shape[0] > 1:
            out = out.clone()
            out[1] = (out[1] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(vlm, "sample_rows", sample_rows)


FAULTS = {"ffn_skipped": _skip_ffn, "kv_writes_dropped": _drop_kv_writes,
          "tokens_altered": _alter_tokens, "one_row_altered": _alter_one_row}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = run(cell)
    assert not out["correct"], out["limits"]


@pytest.mark.card
def test_burst_cell_on_the_card(card):
    """At the cell's own size on the card: the program under the limit,
    the control above it."""
    b = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    s = harness.serve(b, "fastvlm-1.5b.vqa-shared", 77, 8.0, False,
                      t_process=time.perf_counter(), log=lambda m: None)
    got = control.readings(s, 77)
    lim = got["limits"]
    assert all(got["program"][k] <= v for k, v in lim.items()), got
    assert got["control"]["mean_logit_gap"] > lim["mean_logit_gap"]
    assert s.out["device"]["kind"] == card
