"""The port's SFT data pipeline (fastvlm_tpu_torch/data/sft.py, train/sampler.py,
utils/native_image.py) against the JAX package's: the same conversations,
files and seeds give the same ids, labels, collated arrays, sampler order
and pixels. Everything here is exact (``==`` / ``np.array_equal``) except
the PIL comparison of the native loader, which takes JAX's own tolerance
(tests/test_native_image.py: 6e-3)."""

import json

import numpy as np
import pytest

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.data import sft as jsft
from fastvlm_tpu.data.preprocessing import ByteTokenizer as JByteTokenizer
from fastvlm_tpu.data.preprocessing import ImageProcessor as JImageProcessor
from fastvlm_tpu.train import sampler as jsampler
from fastvlm_tpu.utils import native_image as jni
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.data import conversation as tconv
from fastvlm_tpu_torch.data import sft as tsft
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
from fastvlm_tpu_torch.data.preprocessing import ImageProcessor
from fastvlm_tpu_torch.train import sampler as tsampler
from fastvlm_tpu_torch.utils import native_image as tni

import torch_tiny as tt
from torch_tiny import same_image_loader  # noqa: F401 (autouse fixture)

TOK = ByteTokenizer()


class BOSByteTokenizer(ByteTokenizer):
    """Prepends BOS on every call, like HF Llama-family tokenizers."""

    def __call__(self, text: str):
        return self._Enc([self.bos_token_id] + list(text.encode("utf-8")))


class MergingTokenizer:
    """Bytewise, except the pair "xy" -> one id (500), across any span
    boundary: a BPE merge the span builder must mask."""

    bos_token_id = 1

    class _Enc(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text):
        ids, i = [self.bos_token_id], 0
        while i < len(text):
            if text[i:i + 2] == "xy":
                ids.append(500)
                i += 2
            else:
                ids.append(ord(text[i]))
                i += 1
        return self._Enc(ids)


CONVS = {
    "image_two_rounds": [
        {"from": "human", "value": "<image>\nWhat is this?"},
        {"from": "gpt", "value": "A cat."},
        {"from": "human", "value": "Color?"},
        {"from": "gpt", "value": "Black."}],
    "text": [
        {"from": "human", "value": "hello"},
        {"from": "gpt", "value": "world"}],
    "system_turn": [
        {"from": "system", "value": "Be brief."},
        {"from": "human", "value": "q1"},
        {"from": "gpt", "value": "a1"}],
    "merge": [
        {"from": "human", "value": "ax"},
        {"from": "gpt", "value": "yb xy"}],
    "unicode": [
        {"from": "human", "value": "<image>\nQu'est-ce que c'est ? ☕"},
        {"from": "gpt", "value": "Un café — très chaud."}],
}
VERSIONS = ["qwen_2", "v1", "llama_2", "mpt"]


@pytest.mark.parametrize("tok", [TOK, BOSByteTokenizer(), MergingTokenizer()],
                         ids=["byte", "bos", "merging"])
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_preprocess_equals_jax(conv, version, tok):
    got = tsft.PREPROCESSORS[version](CONVS[conv], tok)
    want = jsft.PREPROCESSORS[version](CONVS[conv], tok)
    assert got == want


@pytest.mark.parametrize("tok", [TOK, BOSByteTokenizer(), MergingTokenizer()],
                         ids=["byte", "bos", "merging"])
def test_preprocess_plain_equals_jax(tok):
    convs = [{"from": "human", "value": "<image>"},
             {"from": "gpt", "value": "a photo of a dog xy"}]
    assert tsft.preprocess_plain(convs, tok) == jsft.preprocess_plain(convs,
                                                                      tok)


def test_max_len_truncation_equals_jax():
    convs = CONVS["image_two_rounds"]
    for n in (1, 17, 60):
        assert (tsft.preprocess_qwen_2(convs, TOK, max_len=n)
                == jsft.preprocess_qwen_2(convs, TOK, max_len=n))


def test_span_builder_boundary_merge_equals_jax():
    tok = MergingTokenizer()
    got, want = tsft._SpanBuilder(tok), jsft._SpanBuilder(tok)
    for b in (got, want):
        b.add("ax", False)
        b.add("yb", True)
        b.add("x", False)
        b.add("y", True)
    assert got.ids == want.ids and got.labels == want.labels
    assert got.boundary_merges == want.boundary_merges == 2
    assert got.labels[got.ids.index(500)] == tsft.IGNORE_INDEX


def test_templates_render_byte_exact_and_single_bos():
    """qwen_2 and the SINGLE-separator vicuna_v0 templates, and one BOS at
    the start of every version's ids under a BOS-adding tokenizer."""
    from fastvlm_tpu.data.conversation import conv_templates

    for name in ("qwen_2", "vicuna_v0", "v1", "llama_2", "chatml_direct"):
        got, want = tconv.conv_templates[name].copy(), \
            conv_templates[name].copy()
        for c in (got, want):
            c.append_message(c.roles[0], "Describe.")
            c.append_message(c.roles[1], "A cat.")
            c.append_message(c.roles[0], "Color?")
            c.append_message(c.roles[1], None)
        assert got.get_prompt() == want.get_prompt(), name
    tok = BOSByteTokenizer()
    for version in VERSIONS:
        ids, labels = tsft.PREPROCESSORS[version](CONVS["image_two_rounds"],
                                                  tok)
        assert ids.count(tok.bos_token_id) == 1
        assert ids[0] == tok.bos_token_id
        assert labels[0] == tsft.IGNORE_INDEX


# ---------------------------------------------------------------------------
# a real sentencepiece-style BPE, trained offline (as tests/test_sft_bpe.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_bpe():
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    corpus = [
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions.",
        "[INST] What color is the sky? [/INST] The sky is blue.",
        "<<SYS>> You are a helpful language and vision assistant. <</SYS>>",
        "USER: what is in this image? ASSISTANT: a black cat on a mat.",
        "the quick brown fox jumps over the lazy dog",
        "answer the questions briefly and accurately please",
    ]
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="first")
    trainer = trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=list(
            "abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,?!:'<>/[]()▁\n"))
    tok.train_from_iterator(corpus, trainer)
    bos = tok.token_to_id("<s>")
    tok.post_processor = TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", bos)])
    return PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>", unk_token="<unk>")


BPE_CONVS = [
    {"from": "human", "value": "what color is the sky?"},
    {"from": "gpt", "value": "the sky is blue."},
    {"from": "human", "value": "<image>\nand the cat?"},
    {"from": "gpt", "value": "a black cat."},
]


@pytest.mark.parametrize("version", VERSIONS)
def test_bpe_span_cases_equal_jax(version, llama_bpe):
    got = tsft.PREPROCESSORS[version](BPE_CONVS, llama_bpe)
    want = jsft.PREPROCESSORS[version](BPE_CONVS, llama_bpe)
    assert got == want
    ids, labels = got
    assert ids.count(llama_bpe.bos_token_id) == 1
    assert labels[0] == tsft.IGNORE_INDEX


# ---------------------------------------------------------------------------
# dataset and collate
# ---------------------------------------------------------------------------


def _smooth(w, h, seed=0, noise=0.05):
    """A gradient image, with a little noise from ``seed`` unless noise=0
    (a smooth image has no bicubic overshoot to compare against PIL)."""
    x = np.linspace(0, 1, w)[None, :, None]
    y = np.linspace(0, 1, h)[:, None, None]
    c = np.concatenate([x + 0 * y, y + 0 * x, 0.5 * (x + y)], axis=-1)
    jitter = np.random.RandomState(seed).rand(h, w, 3) * noise
    return ((c * (1 - noise) + jitter) * 255).astype(np.uint8)


@pytest.fixture
def pad_data(tmp_path):
    from PIL import Image

    img = tmp_path / "images"
    img.mkdir()
    Image.fromarray(_smooth(90, 50)).save(img / "a.jpg", quality=95)
    Image.fromarray(_smooth(40, 70, 1)).save(img / "b.png")
    Image.fromarray(_smooth(64, 64, 2)).save(img / "c.jpeg", quality=90)
    data = [
        {"id": "0", "image": "a.jpg", "conversations":
            CONVS["image_two_rounds"]},
        {"id": "1", "conversations": CONVS["text"]},
        {"id": "2", "image": "b.png", "conversations": CONVS["unicode"]},
        {"id": "3", "image": "missing.jpg", "conversations": [
            {"from": "human", "value": "<image>\nX"},
            {"from": "gpt", "value": "Y"}]},
        {"id": "4", "image": "c.jpeg", "conversations": [
            {"from": "human", "value": "<image>\nAgain?"},
            {"from": "gpt", "value": "Yes, again and again."}]},
    ]
    p = tmp_path / "data.json"
    p.write_text(json.dumps(data))
    return str(p), str(img)


def _datasets(data_path, folder, size=64, **kw):
    t = tsft.SupervisedDataset(
        tsft.DataArguments(data_path=data_path, image_folder=folder, **kw),
        TOK, ImageProcessor(size))
    j = jsft.SupervisedDataset(
        jsft.DataArguments(data_path=data_path, image_folder=folder, **kw),
        JByteTokenizer(), JImageProcessor(size))
    return t, j


def _assert_item_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def _assert_batch_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("conv_version", ["qwen_2", "v1", "plain_free"])
def test_dataset_items_and_collate_equal_jax(pad_data, conv_version,
                                             same_image_loader):
    data_path, folder = pad_data
    kw = {"conv_version": conv_version if conv_version != "plain_free"
          else "mpt", "max_len": 48 if conv_version == "v1" else 2048}
    t, j = _datasets(data_path, folder, **kw)
    assert len(t) == len(j) == 5
    assert t.lengths == j.lengths
    assert t.modality_lengths == j.modality_lengths
    items = []
    for i in range(5):
        got, want = t[i], j[i]
        _assert_item_equal(got, want)
        items.append(got)
    # the missing image fell back to sample 0; both loaders ran where the
    # native one loads in both packages (else both are pinned to PIL)
    assert items[3]["ids"] == items[0]["ids"]
    if same_image_loader:
        assert t.image_loads["native"] >= 2 and t.image_loads["pil"] >= 1
    else:
        assert t.image_loads["native"] == 0 and t.image_loads["pil"] >= 3
    for n_img, mult in ((4, 16), (16, 64)):
        got = tsft.collate(items, n_img, pad_to_multiple=mult)
        want = jsft.collate([j[i] for i in range(5)], n_img,
                            pad_to_multiple=mult)
        _assert_batch_equal(got, want)
    text_only = [t[1], t[1]]
    _assert_batch_equal(tsft.collate(text_only, 4),
                        jsft.collate([j[1], j[1]], 4))


def test_text_only_dataset_has_no_images(pad_data):
    data_path, folder = pad_data
    t, j = _datasets(data_path, folder, is_multimodal=False)
    got, want = t[1], j[1]
    assert got["image"] is None and want["image"] is None
    _assert_batch_equal(tsft.collate([got], 4), jsft.collate([want], 4))


def _anyres_cfgs():
    def cfg(pkg, merge):
        vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                                   embed_dims=(8, 16, 32, 64, 128),
                                   image_size=128, attn_head_dim=16)
        decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64,
                                  num_layers=2, num_heads=4, num_kv_heads=2,
                                  head_dim=16, intermediate_size=128)
        return pkg.FastVLMConfig(
            vision=vision, decoder=decoder,
            projector=pkg.ProjectorConfig(
                mm_hidden_size=vision.out_channels, hidden_size=64),
            image_aspect_ratio="anyres", mm_patch_merge_type=merge,
            image_grid_pinpoints=((128, 256), (256, 128), (256, 256)))

    return cfg


@pytest.fixture
def anyres_data(tmp_path):
    from PIL import Image

    img = tmp_path / "images"
    img.mkdir()
    Image.fromarray(_smooth(100, 220)).save(img / "tall.jpg", quality=95)
    Image.fromarray(_smooth(220, 100, 1)).save(img / "wide.png")
    Image.fromarray(_smooth(90, 200, 2)).save(img / "tall2.jpg", quality=95)
    data = [
        {"id": "0", "image": "tall.jpg", "conversations":
            CONVS["image_two_rounds"]},
        {"id": "1", "image": "wide.png", "conversations": CONVS["unicode"]},
        {"id": "2", "image": "tall2.jpg", "conversations": [
            {"from": "human", "value": "<image>\nAgain."},
            {"from": "gpt", "value": "Still purple."}]},
        {"id": "3", "conversations": CONVS["text"]},
    ]
    p = tmp_path / "data.json"
    p.write_text(json.dumps(data))
    return str(p), str(img)


@pytest.mark.parametrize("merge", ["flat", "spatial_unpad"])
def test_anyres_items_and_collate_equal_jax(anyres_data, merge):
    data_path, folder = anyres_data
    make = _anyres_cfgs()
    tc, jc = make(tcfg, merge), make(jcfg, merge)
    t, j = _datasets(data_path, folder, size=128,
                     image_aspect_ratio="anyres",
                     image_grid_pinpoints=tc.image_grid_pinpoints)
    for i in range(4):
        assert t.anyres_meta(i) == j.anyres_meta(i)
        _assert_item_equal(t[i], j[i])
    got = tsft.collate([t[0], t[2]], tc.num_image_tokens, cfg=tc)
    want = jsft.collate([j[0], j[2]], jc.num_image_tokens, cfg=jc)
    _assert_batch_equal(got, want)
    with pytest.raises(ValueError, match="grid-uniform"):
        tsft.collate([t[0], t[1]], tc.num_image_tokens, cfg=tc)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group_by_modality", [False, True])
@pytest.mark.parametrize("lengths", [
    [10, -5, 20, -8, 30, -2, 15, -9, 7, 3, -1],
    list(range(1, 34)),
    [-4, -9, -1, -3, -7]], ids=["mixed", "positive", "negative"])
def test_sampler_order_over_three_epochs_equals_jax(lengths,
                                                     group_by_modality):
    for world in (1, 2):
        got = tsampler.LengthGroupedSampler(
            lengths, 4, world_size=world,
            group_by_modality=group_by_modality, seed=3)
        want = jsampler.LengthGroupedSampler(
            lengths, 4, world_size=world,
            group_by_modality=group_by_modality, seed=3)
        for _ in range(3):
            assert list(got) == list(want)
    rng_t, rng_j = np.random.RandomState(5), np.random.RandomState(5)
    assert (tsampler.get_length_grouped_indices([3, 1, 4, 1, 5, 9, 2, 6], 2,
                                                2, rng_t, merge=False)
            == jsampler.get_length_grouped_indices([3, 1, 4, 1, 5, 9, 2, 6],
                                                   2, 2, rng_j, merge=False))


# ---------------------------------------------------------------------------
# native image loader
# ---------------------------------------------------------------------------


@pytest.fixture
def loaders():
    if not (tni.available() and jni.available()):
        pytest.skip("native image loader not built (no g++ or libjpeg)")
    return tni, jni


def test_native_loader_equals_jax_bitwise(loaders, tmp_path):
    from PIL import Image

    arrs = [_smooth(300, 200), _smooth(77, 131, 3), _smooth(64, 64, 4)]
    paths = []
    for i, arr in enumerate(arrs):
        for mode in (tni.MODE_PAD_SQUARE, tni.MODE_RESIZE_CROP):
            assert np.array_equal(tni.preprocess_rgb(arr, 48, mode),
                                  jni.preprocess_rgb(arr, 48, mode))
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
        data = open(p, "rb").read()
        assert np.array_equal(tni.preprocess_jpeg_bytes(data, 64),
                              jni.preprocess_jpeg_bytes(data, 64))
    paths.append(str(tmp_path / "missing.jpg"))
    got, ok_t = tni.preprocess_files(paths, 32, num_threads=2)
    want, ok_j = jni.preprocess_files(paths, 32, num_threads=2)
    assert list(ok_t) == list(ok_j) == [True] * 3 + [False]
    assert np.array_equal(got[:3], want[:3])


def test_native_loader_against_pil_within_jax_tolerance(loaders):
    from PIL import Image

    from fastvlm_tpu_torch.data.preprocessing import expand2square

    arr = _smooth(300, 200, noise=0)
    ref = ImageProcessor(64).preprocess(
        expand2square(Image.fromarray(arr), (0, 0, 0)))
    got = tni.preprocess_rgb(arr, 64, tni.MODE_PAD_SQUARE)
    np.testing.assert_allclose(got, ref, atol=6e-3)


def test_native_loader_builds_under_the_port_build_dir(loaders):
    import os

    assert tni._LIB_PATH.endswith(
        os.path.join("fastvlm_tpu_torch", "_build", "libfvlm_image.so"))
    assert os.path.exists(tni._LIB_PATH)


def test_loaders_out_of_step_are_pinned_to_one(tmp_path, monkeypatch):
    """JAX's loader stuck on PIL (its in-place build read half-written by
    another test process, which leaves ``_tried`` set for good) while the
    port's decodes natively: the two datasets' images differ, and
    ``torch_tiny.pin_image_loaders`` puts both on one loader, after which
    the trainers' first batches are equal."""
    from fastvlm_tpu.train import trainer as jtrainer
    from fastvlm_tpu_torch.train import trainer as ttrainer

    data = tt.sft_records(tmp_path)
    monkeypatch.setattr(jni, "_lib", None)
    monkeypatch.setattr(jni, "_tried", True)
    t, j = tt.sft_datasets(data)
    imaged = next(i for i in range(len(t)) if t[i]["has_image"]
                  and t.records[i]["image"].endswith(".jpg"))
    if tni.available():
        assert not np.array_equal(t[imaged]["image"], j[imaged]["image"])
    native = tt.pin_image_loaders(monkeypatch)
    assert native == (jni._lib is not None) == (tni._lib is not None)
    t, j = tt.sft_datasets(data)
    assert np.array_equal(t[imaged]["image"], j[imaged]["image"])
    got = next(ttrainer.batches(t, ttrainer.LengthGroupedSampler(
        t.lengths, 4, seed=0), 4, 4))
    want = next(jtrainer.batches(j, jtrainer.LengthGroupedSampler(
        j.lengths, 4, seed=0), 4, 4))
    _assert_batch_equal(got, want)
