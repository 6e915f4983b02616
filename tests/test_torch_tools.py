"""The port's weight tools (fastvlm_tpu_torch/utils/weights.py) and eval
harness (fastvlm_tpu_torch/eval/run_eval.py) against the JAX package's:

* ``make_delta`` / ``apply_delta`` / ``consolidate`` on converted trees
  equal the JAX functions' output converted (float32 and bfloat16 leaves,
  an int8 leaf, an embedding grown by added tokens stored whole); the CLI
  over native bundles gives the same trees;
* ``normalize`` and ``score`` equal JAX's on a table of cases;
* ``run_eval.main`` over the tiny engine (both packages' ``build_engine``
  patched to the same weights) on a 3-item JSON gives JAX's summary and
  predictions;
* each CLI's default ``--device cuda`` refuses to run without a card.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastvlm_tpu import engine as jengine
from fastvlm_tpu.eval import run_eval as jeval
from fastvlm_tpu.utils import weights as jweights
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.eval import run_eval as teval
from fastvlm_tpu_torch.utils import checkpoint as tckpt
from fastvlm_tpu_torch.utils import weights as tweights
from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

import torch_tiny

N_LAYERS = 2


def _decoder(seed, vocab=258, bf16=False):
    """A stacked JAX-layout decoder tree of numpy leaves (the tiny VLM's),
    with an int8 leaf; ``bf16`` stores the matrices in bfloat16."""
    dec = torch_tiny.draw_weights(seed)["decoder"]
    rng = np.random.RandomState(seed)
    dec["embed"] = rng.randn(vocab, 64).astype(np.float32) * 0.2
    dec["lm_head"] = {"w": rng.randn(64, vocab).astype(np.float32) * 0.2}
    dec["layers"]["o"]["w_q"] = rng.randint(-60, 60, (N_LAYERS, 8, 4),
                                            dtype=np.int8)
    if bf16:
        dec["layers"] = jax.tree.map(
            lambda a: a.astype(ml_dtypes.bfloat16) if a.dtype == np.float32
            and a.ndim == 3 else a, dec["layers"])
    return dec


def _port(tree):
    return qwen2_from_jax(tree, N_LAYERS)


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _assert_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_delta_roundtrip_matches_jax(bf16):
    base = _decoder(0, bf16=bf16)
    # the target grew its vocabulary: embed and lm_head change shape
    target = _decoder(1, vocab=260, bf16=bf16)
    jdelta = jweights.make_delta(base, target)
    tdelta = tweights.make_delta(_port(base), _port(target))
    _assert_equal(tdelta, _port(jax.tree.map(np.asarray, jdelta)))
    assert tdelta["embed"].shape == (260, 64)  # stored whole
    japplied = jweights.apply_delta(base, jdelta)
    tapplied = tweights.apply_delta(_port(base), tdelta)
    _assert_equal(tapplied, _port(jax.tree.map(np.asarray, japplied)))
    # the int8 leaf comes back exactly (its delta is exact in f32)
    assert torch.equal(tapplied["layers"][0]["o"]["w_q"],
                       _port(target)["layers"][0]["o"]["w_q"])
    _assert_equal(tweights.consolidate(tapplied), tapplied)


def test_int8_delta_wraps_like_jax():
    """An int8 leaf's delta can leave int8's range (|t - b| up to 254): the
    JAX delta casts the f32 difference back to int8, which wraps, and the
    apply wraps back to the target. The port computes the same bytes
    (ROADMAP Queue 3)."""
    b = np.array([[-100, 100, -127, 5, 0, 127]], np.int8)
    t = np.array([[100, -100, 127, -5, -128, -128]], np.int8)
    with np.errstate(invalid="ignore"):
        jd = jweights.make_delta({"w_q": b}, {"w_q": t})["w_q"]
        ja = jweights.apply_delta({"w_q": b}, {"w_q": jd})["w_q"]
    td = tweights.make_delta({"w_q": torch.from_numpy(b)},
                             {"w_q": torch.from_numpy(t)})["w_q"]
    ta = tweights.apply_delta({"w_q": torch.from_numpy(b)},
                              {"w_q": td})["w_q"]
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ta.numpy(), t)


def test_weights_cli_over_native_bundles(tmp_path):
    base, target = _port(_decoder(0)), _port(_decoder(1, vocab=260))
    paths = {n: str(tmp_path / n) for n in ("b", "t", "d", "t2", "c")}
    tckpt.save_native(paths["b"], base)
    tckpt.save_native(paths["t"], target)
    cpu = ["--device", "cpu"]
    assert tweights.main(["make-delta", "--base", paths["b"], "--target",
                          paths["t"], "--delta", paths["d"]] + cpu) == 0
    _assert_equal(tckpt.restore_native(paths["d"]),
                  tweights.make_delta(base, target))
    assert tweights.main(["apply-delta", "--base", paths["b"], "--target",
                          paths["t2"], "--delta", paths["d"]] + cpu) == 0
    applied = tweights.apply_delta(base, tweights.make_delta(base, target))
    _assert_equal(tckpt.restore_native(paths["t2"]), applied)
    assert tweights.main(["consolidate", "--src", paths["t2"], "--dst",
                          paths["c"]] + cpu) == 0
    _assert_equal(tckpt.restore_native(paths["c"]), applied)


SCORE_CASES = [
    ("A cat.", ["cat"], "exact"),
    ("The cat", ["a cat"], "exact"),
    ("dog", ["cat"], "exact"),
    ("there is a red car here", ["red car"], "substring"),
    ("nothing", ["", "red"], "substring"),
    ("Two!", ["two", "2", "two", "three"], "vqa"),
    ("two dogs", ["two", "two", "two", "two"], "vqa"),
    ("yes", ["no"], "vqa"),
    ("An apple, an orange.", ["apple orange"], "vqa"),
    ("  ", [""], "vqa"),
]


@pytest.mark.parametrize("pred,answers,metric", SCORE_CASES)
def test_score_and_normalize_match_jax(pred, answers, metric):
    assert teval.normalize(pred) == jeval.normalize(pred)
    assert teval.score(pred, answers, metric) == \
        jeval.score(pred, answers, metric)


def test_score_unknown_metric_raises():
    with pytest.raises(ValueError):
        teval.score("a", ["a"], "bleu")


def test_run_eval_main_matches_jax(tmp_path, monkeypatch, capsys):
    """3 items (an image, text only, a list of answers) through both
    harnesses over engines of the same weights: equal predictions and
    scores, and equal summaries but for the wall time."""
    from PIL import Image

    je, te = torch_tiny.engines(torch_tiny.draw_weights(4))
    monkeypatch.setattr(jengine, "build_engine", lambda *a, **k: je)
    monkeypatch.setattr(tengine, "build_engine", lambda *a, **k: te)
    Image.fromarray(torch_tiny.image(6)).save(tmp_path / "img.png")
    first, _ = te.chat("What is it?", Image.open(tmp_path / "img.png")
                       .convert("RGB"), max_new_tokens=4)
    items = [{"id": "a", "image": "img.png", "question": "What is it?",
              "answer": first},
             {"question": "Say something.", "answers": ["x", "y", "z"]},
             {"question": "Count.", "answer": "1"}]
    (tmp_path / "q.json").write_text(json.dumps(items))
    common = ["--questions", str(tmp_path / "q.json"), "--image-folder",
              str(tmp_path), "--max-new-tokens", "4"]
    out = {}
    for name, mod, extra in (("jax", jeval, []),
                             ("port", teval, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.json")
        assert mod.main(common + ["--output", path] + extra) == 0
        out[name] = json.load(open(path))
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == out[name]["summary"]
    for o in out.values():
        o["summary"].pop("wall_s")
        for r in o["results"]:
            r.pop("stats")
    assert out["port"] == out["jax"]
    assert out["port"]["summary"]["accuracy"] >= 1 / 3  # item a scores


@pytest.mark.parametrize("argv", [
    ["consolidate", "--src", "a", "--dst", "b"],
    ["make-delta", "--base", "a", "--target", "b", "--delta", "c"]])
def test_weights_cli_default_device_needs_a_card(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tweights.main(argv)
    assert e.value.code != 0


def test_run_eval_default_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "q.json").write_text("[]")
    with pytest.raises(SystemExit) as e:
        teval.main(["--random-weights", "--questions",
                    str(tmp_path / "q.json")])
    assert e.value.code != 0
