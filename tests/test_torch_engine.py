"""The port's host path and whole engine against the JAX package's.

* rendered prompts, token ids and pixels are equal;
* tiny greedy ``Engine.generate`` gives the same ids in both packages, for
  two prompts (the slice gate), f32, same weights via utils/convert.py;
* importing every module of the port leaves JAX unimported;
* the predict CLI refuses the flags whose paths are not yet ported, and
  ``--spec-decode`` runs greedy only.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.data import conversation as jconv
from fastvlm_tpu.data import preprocessing as jpre
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import sampling as jsampling
from fastvlm_tpu.ops import splice as jsplice
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine, predict
from fastvlm_tpu_torch.data import conversation, preprocessing
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.ops import sampling, splice
from fastvlm_tpu_torch.utils.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids, so the engines'
    text output is their token ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def _tiny(pkg, **extra):
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64))


@pytest.fixture(scope="module")
def engines():
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    tc = _tiny(tcfg)
    # random weights of the JAX init's shapes, drawn with numpy (running the
    # JAX init op by op costs ~10 s here): norm scales near 1, everything
    # else N(0, 0.02), the decoder's matrices and embeddings x10 (at 0.02 the
    # tiny decoder only echoes its last input token)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        decoder_matrix = path[0].key == "decoder" and leaf.ndim >= 2
        scale = 0.2 if decoder_matrix else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_params(params, tc)
    tok = IdTokenizer()
    je = jengine.Engine(jc, jp, tok, eos_ids=(tok.eos_token_id,))
    te = engine.Engine(tc, tp, tok, eos_ids=(tok.eos_token_id,))
    return je, te


def _image(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=(128, 128, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_templates_render_identically(name):
    dialogues = [["<image>\nWhat is this?", None]]
    if name != "plain":  # plain holds single (image, caption) pairs only
        dialogues.append(["<image>\nWhat is this?", "A cat.", "And now?", None])
    for system in (None, "Be brief."):
        for turns in dialogues:
            rendered = []
            for mod in (jconv, conversation):
                conv = mod.conv_templates[name].copy()
                if system is not None:
                    conv.system = system
                for i, msg in enumerate(turns):
                    conv.append_message(conv.roles[i % 2], msg)
                rendered.append(conv.get_prompt())
            assert rendered[0] == rendered[1]


def test_prepare_ids_and_pixels_match_jax(engines):
    je, te = engines
    prompt = te.build_prompt("Describe the image.")
    assert prompt == je.build_prompt("Describe the image.")
    image = _image()
    jin, tin = je.prepare(prompt, image), te.prepare(prompt, image)
    for k in ("ids", "lens", "starts"):
        np.testing.assert_array_equal(tin[k].cpu().numpy(), np.asarray(jin[k]))
    np.testing.assert_allclose(tin["images"].cpu().numpy(),
                               np.asarray(jin["images"]), rtol=0, atol=1e-7)


def test_array_image_rules_match_jax(engines):
    """Float arrays with max > 1.5 are taken as [0, 255], [0, 1] floats pass
    as they are; arrays of another size than the model's are padded and
    resized as the JAX engine does them (to float rounding of the bicubic
    weights: atol 1e-5, tests/test_torch_image_ops.py)."""
    je, te = engines
    x = np.random.RandomState(5).rand(128, 128, 3).astype(np.float32)
    for arr in (x, x * 255.0):
        np.testing.assert_allclose(
            te.prepare_array_image(arr).numpy(),
            np.asarray(je.prepare_array_image(arr)), rtol=0, atol=1e-7)
    got = te.prepare_array_image(x[:64])
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(je.prepare_array_image(x[:64])),
                               rtol=0, atol=1e-5)


def test_pil_pad_preprocessing_matches_jax():
    from PIL import Image

    img = Image.fromarray(_image(1)[:96])  # non-square: pad mode squares it
    cfg = tcfg.FastVLMConfig()
    want = jpre.process_images([img], jpre.ImageProcessor(64), cfg)
    got = preprocessing.process_images([img], preprocessing.ImageProcessor(64),
                                       cfg)
    np.testing.assert_array_equal(got, want)
    ids = preprocessing.tokenizer_image_token("a <image>\nb",
                                              preprocessing.ByteTokenizer())
    assert ids == jpre.tokenizer_image_token("a <image>\nb",
                                             jpre.ByteTokenizer())


@pytest.mark.parametrize("prompt", ["Describe the image.",
                                    "What color is the sky?"])
def test_greedy_generate_ids_equal_jax(engines, prompt):
    """The slice gate: same weights, same inputs, equal greedy ids."""
    je, te = engines
    image = _image(2)
    full = te.build_prompt(prompt)
    jtext, jstats = je.generate(full, image, max_new_tokens=20,
                                sampling=jsampling.SamplingParams())
    ttext, tstats = te.generate(full, image, max_new_tokens=20,
                                sampling=sampling.SamplingParams())
    assert ttext == jtext
    assert len(set(ttext.split(","))) >= 3  # not one token repeated
    assert tstats["decode_tokens"] == jstats["decode_tokens"]
    assert tstats["prompt_tokens"] == jstats["prompt_tokens"]


def test_vlm_generate_matches_jax(engines):
    """The whole-generation function (prefill + decode loop), greedy, on the
    engines' (folded) weights: equal tokens and counts."""
    je, te = engines
    jin = je.prepare(te.build_prompt("Describe the image."), _image(3))
    tin = te.prepare(te.build_prompt("Describe the image."), _image(3))
    want = jvlm.generate(je.params, je.cfg, jin["images"], jin["ids"],
                         jin["lens"], jin["starts"], jax.random.PRNGKey(0),
                         max_new_tokens=12, eos_ids=(257,))
    got = tvlm.generate(te.params, te.cfg, tin["images"], tin["ids"],
                        tin["lens"], tin["starts"], max_new_tokens=12,
                        eos_ids=(257,))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))


def test_stop_strings_and_keywords_trim_like_jax(engines):
    je, te = engines
    full = te.build_prompt("Describe the image.")
    image = _image(2)
    text, _ = te.generate(full, image, max_new_tokens=20)
    stop = ",".join(text.split(",")[5:7])  # a stop string seen in the output
    jt, _ = je.generate(full, image, max_new_tokens=20, stop_strings=[stop])
    tt, _ = te.generate(full, image, max_new_tokens=20, stop_strings=[stop])
    assert tt == jt == text.split(stop)[0]
    assert len(tt) < len(text)


def test_sampling_filters_match_jax():
    logits = np.random.RandomState(4).randn(3, 50).astype(np.float32)
    np.testing.assert_array_equal(
        sampling._apply_top_k(torch.from_numpy(logits), 5).numpy(),
        np.asarray(jsampling._apply_top_k(jnp.asarray(logits), 5)))
    np.testing.assert_array_equal(
        sampling._apply_top_p(torch.from_numpy(logits), 0.7).numpy(),
        np.asarray(jsampling._apply_top_p(jnp.asarray(logits), 0.7)))
    np.testing.assert_array_equal(
        sampling.greedy(torch.from_numpy(logits)).numpy(),
        np.asarray(jsampling.greedy(jnp.asarray(logits))))


def test_sampling_is_seeded_by_generator():
    logits = torch.from_numpy(np.random.RandomState(5).randn(4, 30)
                              .astype(np.float32))
    params = sampling.SamplingParams(temperature=0.8, top_p=0.9, top_k=10)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        draws.append(sampling.sample(gen, logits, params))
    torch.testing.assert_close(draws[0], draws[1])
    kth = torch.topk(logits, 10).values[:, -1]
    assert bool((logits[torch.arange(4), draws[0].long()] >= kth).all())


def test_splice_matches_jax():
    ids = [1, 2, -200, 3]
    row, start = splice.expand_image_ids(ids, 4)
    jrow, jstart = jsplice.expand_image_ids(ids, 4)
    np.testing.assert_array_equal(row, jrow)
    assert start == jstart
    rng = np.random.RandomState(6)
    text = rng.randn(2, 9, 5).astype(np.float32)
    img = rng.randn(2, 4, 5).astype(np.float32)
    starts = np.array([2, -1], np.int32)
    np.testing.assert_array_equal(
        splice.overlay_image_embeds(torch.from_numpy(text), torch.from_numpy(img),
                                    torch.from_numpy(starts)).numpy(),
        np.asarray(jsplice.overlay_image_embeds(
            jnp.asarray(text), jnp.asarray(img), jnp.asarray(starts))))


def test_port_never_imports_jax():
    code = (
        "import pkgutil, sys, importlib, fastvlm_tpu_torch\n"
        "for m in pkgutil.walk_packages(fastvlm_tpu_torch.__path__, "
        "'fastvlm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import fastvlm_tpu_torch.engine\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('fastvlm_tpu.') or m == 'fastvlm_tpu'\n"
        "       or m == 'triton']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("flags", [
    ["--num_beams", "2"], [],
    ["--verify-checkpoint"], ["--model-path", "ckpt"],
])
def test_predict_refuses_unported_flags(flags, monkeypatch, capsys):
    """``--tp 2`` outside a world of 2 processes is refused, beside each
    flag that runs, with the message that names torchrun (the ranks are
    the processes it starts), and names nothing else."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert predict.main(["--random-weights", "--tp", "2", *flags]) == 2
    err = capsys.readouterr().err
    assert err.startswith("--tp 2 needs a world of 2 processes")
    assert "torchrun --nproc-per-node 2 -m fastvlm_tpu_torch.predict" in err
    assert "--num_beams" not in err and "not yet ported" not in err


def test_predict_random_weights_runs(capsys):
    assert predict.main(["--random-weights", "--device", "cpu",
                         "--max-new-tokens", "3", "--temperature", "0",
                         "--timing"]) == 0
    assert '"ttft_ms"' in capsys.readouterr().err


@pytest.mark.parametrize("draft_k", ["8", "3"])
def test_predict_spec_decode_runs_greedy(draft_k, capsys):
    """``--spec-decode --temperature 0`` prints the greedy run's text."""
    base = ["--random-weights", "--device", "cpu", "--max-new-tokens", "6",
            "--temperature", "0"]
    assert predict.main(base) == 0
    plain = capsys.readouterr().out
    assert predict.main(base + ["--spec-decode", "--draft-k", draft_k,
                                "--timing"]) == 0
    out = capsys.readouterr()
    assert out.out == plain
    assert '"tokens"' in out.err


def test_predict_spec_decode_requires_greedy(capsys):
    with pytest.raises(SystemExit) as exc:
        predict.main(["--random-weights", "--device", "cpu", "--spec-decode",
                      "--max-new-tokens", "2"])  # default temperature 0.2
    assert exc.value.code != 0
    assert "greedy-only" in capsys.readouterr().err


def test_build_engine_refuses_without_a_card(monkeypatch):
    """The entry points run on the card unless the caller asks for the CPU:
    without a card the default raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.build_engine(random_tiny=True)
    assert engine.build_engine(random_tiny=True, device="cpu").device.type == "cpu"


def test_predict_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert predict.main(["--random-weights", "--max-new-tokens", "1"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
