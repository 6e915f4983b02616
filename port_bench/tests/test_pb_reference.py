"""The plain reference against the port at a tiny size on the CPU, both
in float32 on the same weights: the tower and projector, the prefill's
logits and teacher-forced decode steps through the dense cache, for the
dense family and for the test's Mistral family (a sliding window). (The
test may import both; the reference module and the family modules import
nothing of the port.)"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from port_bench import family, harness, loadgen, weights
from port_bench.reference import q8

DATA = os.path.join(os.path.dirname(__file__), "data")


def tiny(name="tiny.json"):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("path", [
    "port_bench/reference.py", family.DEFAULT,
    tiny("tiny-mistral.json")["decoder"]])
def test_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(open(os.path.join(harness.REPO, path)).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    banned = {"fastvlm_tpu_torch", "fastvlm_tpu", "jax"}
    if path == "port_bench/reference.py":
        banned.add("port_bench")
    assert not [n for n in names if n.split(".")[0] in banned]


def _port(cfg, seed):
    tree = weights.draw(cfg, seed, "cpu", torch.float32)
    engine = harness.build_engine(cfg, {"engine": {"chunk": 4}}, tree,
                                  "float32")
    return engine, weights.draw(cfg, seed, "cpu", torch.float32)


def test_tower_and_projector_match_the_port():
    from fastvlm_tpu_torch.models import vlm

    cfg = tiny()
    engine, tree = _port(cfg, 11)
    ref = family.of(cfg).Reference(cfg, tree)
    rng = np.random.default_rng(0)
    s = cfg["vision"]["image_size"]
    img = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
    with torch.inference_mode():
        got = vlm.encode_images(engine.params, engine.cfg,
                                engine.prepare_array_image(img))[0]
        want = ref.image_embeds(torch.as_tensor(img))
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * scale)
    # the layer scales reach the features: the tower is not the identity
    feats = ref.tower(torch.as_tensor(img))
    assert float(feats.std()) > 1e-3


# the Mistral case's system text puts the question and answer past its
# 40-key window
@pytest.mark.parametrize("name,system", [("tiny.json", "sys"),
                                         ("tiny-mistral.json", "sys " * 30)])
def test_prefill_and_decode_logits_match_the_port(name, system):
    from fastvlm_tpu_torch.models import vlm

    cfg = tiny(name)
    engine, tree = _port(cfg, 12)
    ref = family.of(cfg).Reference(cfg, tree)
    s = cfg["vision"]["image_size"]
    img = np.random.default_rng(1).integers(0, 256, (s, s, 3), np.uint8)
    prompt = loadgen.render(system, "what is this?")
    steps = 5
    with torch.inference_mode():
        inputs = engine.prepare(prompt, img)
        t = inputs["ids"].shape[1]
        cache = engine.new_cache(1, t + steps + 1)
        logits, cache = vlm.prefill(engine.params, engine.cfg,
                                    inputs["images"], inputs["ids"],
                                    inputs["lens"], inputs["starts"], cache)
        rows, toks = [logits[0]], []
        for _ in range(steps):
            tok = rows[-1].argmax(-1).to(torch.int32)[None]
            toks.append(int(tok))
            logits, cache = vlm.decode_step(engine.params, engine.cfg, tok,
                                            cache)
            rows.append(logits[0])
        got = torch.stack(rows)
        ids, at = loadgen.prompt_ids(prompt, 16)
        assert len(ids) == inputs["prompt_tokens"]
        want = ref.logits(ids + toks, torch.as_tensor(img), at,
                          range(len(ids) - 1, len(ids) + steps))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    e8 = (q8(x, -1) - x).abs().max() / x.abs().max()
    e16 = (x.bfloat16().float() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16
    assert (q8(x, -1).abs().amax(-1) <= x.abs().amax(-1) * 1.0001).all()
