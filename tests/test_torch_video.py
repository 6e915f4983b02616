"""The port's video-frame QA (fastvlm_tpu_torch/video.py) against the JAX
package's (fastvlm_tpu/video.py), mirroring tests/test_video.py: per-frame
greedy ids equal the JAX ``VideoQA``'s and the port's full-prefill
``Engine.chat``'s; frames do not leak into each other; a non-native uint8
camera frame is resized on the device; the pipelined stream answers as the
sequential one; ``dispatch`` reads nothing back to the host. With
``spec=True`` (speculative decode seeded by the previous frame's answer)
the answers and verify passes equal the JAX ``VideoQA(spec=True)``'s and the
plain answers, pipelined or not.

f32 at tiny sizes (128 px, 4 image tokens), the same numpy-drawn weights on
both sides (utils/convert.py), a tokenizer whose text is the token ids. Ids
are compared for equality; resized pixels agree to atol 1e-5
(tests/test_torch_image_ops.py), far inside the margin of a greedy flip at
these weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu import video as jvideo
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.ops.sampling import SamplingParams
from fastvlm_tpu_torch.utils.convert import from_jax_params
from fastvlm_tpu_torch.video import VideoQA, qa_over_stream

QUESTION = "What do you see?"


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

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
    """(JAX engine, port engine) over the same numpy-drawn weights; EOS is
    unreachable, so every answer runs to its cap. The encoder's and
    projector's matrices are drawn at 1/sqrt(fan-in), so that frames reach
    the KV (at the init's 0.02 the biases drown the pixels)."""
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    tc = _tiny(tcfg)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        if leaf.ndim < 2:
            scale = 0.02
        elif path[0].key == "decoder":
            scale = 0.2
        else:
            scale = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tok = IdTokenizer()
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, params), tok,
                        eos_ids=(-1,))
    te = engine.Engine(tc, from_jax_params(params, tc), tok, eos_ids=(-1,))
    return je, te


def _frame(seed, shape=(128, 128, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _odd_frame():
    """A camera-like uint8 frame at a non-native, non-square size."""
    return (np.random.RandomState(1).rand(96, 160, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_answers(engines):
    """The JAX VideoQA's answers (6 new tokens) to frames 0, 1, 0 and the
    odd-sized uint8 frame, in that order, through one VideoQA."""
    je, _ = engines
    vq = jvideo.VideoQA(je, QUESTION, max_new_tokens=6)
    return [vq.ask(f)[0] for f in (_frame(0), _frame(1), _frame(0),
                                   _odd_frame())]


def test_video_qa_frames_consistent_and_independent(engines, jax_answers):
    """Same frame twice -> same answer and the same cache (nothing of the
    frame between leaks); every answer equals the JAX VideoQA's and the
    port's full-prefill engine's."""
    _, te = engines
    vq = VideoQA(te, QUESTION, max_new_tokens=6)
    frames = (_frame(0), _frame(1), _frame(0))
    got, caches = [], []
    for f in frames:
        got.append(vq.ask(f))
        caches.append(vq.cache.k[:, :, :int(vq.cache.lengths[0])].clone())
    texts = [t for t, _ in got]
    assert texts == jax_answers[:3]
    assert texts[0] == texts[2]
    assert torch.equal(caches[0], caches[2])
    assert not torch.equal(caches[0], caches[1])  # the frames reach the KV
    assert all(s["ttft_ms"] > 0 and s["tokens"] == 6 for _, s in got)
    serial = [te.chat(QUESTION, f, max_new_tokens=6)[0] for f in frames]
    assert texts == serial


def test_qa_over_stream(engines):
    _, te = engines
    vq = VideoQA(te, "Describe", max_new_tokens=3)
    frames = [_frame(s) for s in range(3)]
    for latest_only in (False, True):
        results = list(qa_over_stream(vq, frames, latest_only=latest_only))
        assert len(results) == 3
        assert all(isinstance(t, str) and s["tokens"] == 3
                   for t, s in results)


def test_video_qa_nonsquare_uint8_frame_is_preprocessed(engines,
                                                        jax_answers):
    """A raw camera frame at a non-native size is padded and resized on the
    device, so the tower emits exactly num_image_tokens: the answer equals
    the JAX VideoQA's; uint8 and the same content as [0, 1] floats agree."""
    _, te = engines
    vq = VideoQA(te, QUESTION, max_new_tokens=6)
    odd, stats = vq.ask(_odd_frame())
    assert odd == jax_answers[3] and stats["ttft_ms"] > 0
    square = (np.random.RandomState(2).rand(128, 128, 3) * 255).astype(
        np.uint8)
    a_u8, _ = vq.ask(square)
    a_f32, _ = vq.ask(square.astype(np.float32) / 255.0)
    assert a_u8 == a_f32


def test_engine_prepare_array_image_shapes(engines):
    _, te = engines
    s = te.cfg.vision.image_size
    for shape, dtype in [((s, s, 3), np.uint8), ((100, 300, 3), np.uint8),
                         ((2, 77, 33, 3), np.float32)]:
        out = te.prepare_array_image(np.zeros(shape, dtype))
        b = shape[0] if len(shape) == 4 else 1
        assert out.shape == (b, s, s, 3), (shape, out.shape)


def test_pipelined_stream_matches_sequential(engines, jax_answers):
    """Double-buffered dispatch / finish gives the sequential ask() loop's
    answers, which are the JAX VideoQA's (greedy, same frames)."""
    _, te = engines
    frames = [_frame(0), _frame(1), _frame(0)]
    seq = [t for t, _ in qa_over_stream(
        VideoQA(te, QUESTION, max_new_tokens=6), frames, latest_only=False)]
    piped = [t for t, _ in qa_over_stream(
        VideoQA(te, QUESTION, max_new_tokens=6), frames, latest_only=False,
        pipelined=True)]
    assert piped == seq == jax_answers[:3], (piped, seq)


def test_dispatch_reads_nothing_back(engines, monkeypatch):
    """``dispatch`` queues the frame's work without a host read: no int(),
    bool(), .cpu(), .tolist() or .numpy() of a tensor until ``finish``."""
    _, te = engines
    vq = VideoQA(te, QUESTION, max_new_tokens=20)
    frame = _frame(3)

    def read(*_a, **_k):
        raise AssertionError("dispatch read a tensor back to the host")

    with monkeypatch.context() as m:
        for name in ("__int__", "__bool__", "__index__", "cpu", "tolist",
                     "numpy"):
            m.setattr(torch.Tensor, name, read)
        state = vq.dispatch(frame)
    text, stats = vq.finish(state)
    assert stats["tokens"] == 20
    assert text == te.chat(QUESTION, frame, max_new_tokens=20)[0]


SPEC_FRAMES = (0, 1, 0)


@pytest.fixture(scope="module")
def jax_spec_answers(engines):
    """The JAX VideoQA(spec=True)'s (answer, spec_steps) for frames 0, 1, 0
    (8 new tokens, draft_k 4)."""
    je, _ = engines
    vq = jvideo.VideoQA(je, QUESTION, max_new_tokens=8, spec=True, draft_k=4)
    out = []
    for s in SPEC_FRAMES:
        text, stats = vq.ask(_frame(s))
        out.append((text, stats["spec_steps"]))
    return out


def test_video_spec_matches_jax(engines, jax_spec_answers, jax_answers):
    """Answers and verify passes equal JAX's; the answers are the plain
    VideoQA's (6 tokens of them: jax_answers). The second frame drafts from
    the first frame's answer (the same here), so it verifies in fewer
    passes."""
    _, te = engines
    vq = VideoQA(te, QUESTION, max_new_tokens=8, spec=True, draft_k=4)
    got = [vq.ask(_frame(s)) for s in SPEC_FRAMES]
    assert [(t, s["spec_steps"]) for t, s in got] == jax_spec_answers
    assert got[1][1]["spec_steps"] < got[0][1]["spec_steps"]
    for (text, stats), plain in zip(got, jax_answers[:3]):
        assert text.startswith(plain) and stats["tokens"] == 8
        assert 0.0 <= stats["spec_accept_rate"] <= 1.0
    plain8 = VideoQA(te, QUESTION, max_new_tokens=8)
    assert [t for t, _ in got] == [plain8.ask(_frame(s))[0]
                                   for s in SPEC_FRAMES]


def test_video_spec_pipelined_matches_sequential(engines, jax_spec_answers):
    _, te = engines
    frames = [_frame(s) for s in SPEC_FRAMES]
    seq = list(qa_over_stream(
        VideoQA(te, QUESTION, max_new_tokens=8, spec=True, draft_k=4),
        frames, latest_only=False))
    piped = list(qa_over_stream(
        VideoQA(te, QUESTION, max_new_tokens=8, spec=True, draft_k=4),
        frames, latest_only=False, pipelined=True))
    assert [t for t, _ in piped] == [t for t, _ in seq]
    assert [(t, s["spec_steps"]) for t, s in piped] == jax_spec_answers


def test_video_spec_rejects_sampling(engines):
    _, te = engines
    with pytest.raises(ValueError, match="greedy-only"):
        VideoQA(te, QUESTION, spec=True,
                sampling=SamplingParams(temperature=0.5))

