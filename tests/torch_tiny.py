"""Shared set-up of the quantization, int8-KV, export, tools and training
tests of the PyTorch port: the tiny VLM (128 px FastViTHD, 2-layer decoder)
in both packages, weights drawn with numpy once and converted
(utils/convert.py), a tokenizer whose text is the token ids, and for
training a live tower, 12 synthetic records and a pair of trainers."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.data import preprocessing as jpreprocessing
from fastvlm_tpu.data import sft as jsft
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.train import trainer as jtrainer
from fastvlm_tpu.utils import native_image as jni
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.data import sft as tsft
from fastvlm_tpu_torch.train import trainer as ttrainer
from fastvlm_tpu_torch.utils import native_image as tni
from fastvlm_tpu_torch.utils.convert import from_jax_params


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def tiny(pkg, kv_cache_dtype=None, **extra):
    """The tiny VLM config of ``pkg`` (either package's ``config``): 128 px
    FastViTHD (4 image tokens), a 2-layer 64-wide decoder, untied LM head
    unless ``extra`` ties it."""
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              tie_word_embeddings=False,
                              kv_cache_dtype=kv_cache_dtype,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64))


def jax_config(kv_cache_dtype=None):
    """The JAX side runs its Pallas kernels (interpret mode on the CPU)."""
    return tiny(jcfg, kv_cache_dtype, vision={"ffn_backend": "pallas"},
                decoder={"attn_backend": "pallas"})


def draw_weights(seed=0):
    """numpy weights of the JAX init's shapes: norm scales near 1, the
    decoder's matrices and embeddings N(0, 0.2) (at 0.02 the tiny decoder
    only echoes its last input token), the rest N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    jc = jax_config()
    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def engines(np_params, kv_cache_dtype=None, **engine_kw):
    """(JAX engine, port engine) over the same numpy tree (which may hold
    quantized decoder leaves)."""
    tok = IdTokenizer()
    engine_kw.setdefault("eos_ids", (tok.eos_token_id,))
    jc = jax_config(kv_cache_dtype)
    tc = tiny(tcfg, kv_cache_dtype)
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, np_params), tok,
                        **engine_kw)
    te = tengine.Engine(tc, from_jax_params(np_params, tc), tok, **engine_kw)
    return je, te


def with_decoder(cfg, **kw):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                **kw))


def image(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (128, 128, 3),
                                               dtype=np.uint8)


# ---------------------------------------------------------------------------
# training (tests/test_torch_train_step.py, test_torch_lora.py,
# test_torch_trainer.py): the JAX side keeps its training defaults (XLA FFN)
# ---------------------------------------------------------------------------


def train_config(pkg, merge="flat", **decoder):
    """The tiny training config of ``train_sft --random-tiny`` in ``pkg``
    (tied head over the byte tokenizer's 258 ids), optionally anyres with
    ``merge`` and the 128 px tile pinpoints."""
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16)
    dec = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          intermediate_size=128, **decoder)
    kw = {}
    if merge != "flat":
        kw = {"image_aspect_ratio": "anyres", "mm_patch_merge_type": merge,
              "image_grid_pinpoints": ((128, 256), (256, 128), (256, 256))}
    return pkg.FastVLMConfig(
        vision=vision, decoder=dec,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64), **kw)


def live_weights(jc, seed=0):
    """numpy weights of ``jc``'s shapes with a live tower: every matrix and
    kernel N(0, 1/fan_in) (fan_in = all but the last, output, axis), layer
    scales near 0.5, norm scales near 1, other vectors N(0, 0.02); the
    decoder's matrices N(0, 0.2) as ``draw_weights``. At the init's 0.02
    std the tower's features and gradients underflow toward 0."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, top = path[-1].key, path[0].key
        shape = leaf.shape
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*shape)).astype(np.float32)
        if name.startswith("ls"):
            return (0.5 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if top == "decoder" and leaf.ndim >= 2:
            return (0.2 * rng.randn(*shape)).astype(np.float32)
        # a tower block's leaves carry the scan's leading axis
        stacked = any(getattr(k, "key", None) == "blocks" for k in path)
        core = shape[1:] if stacked else shape
        if len(core) >= 2 and top != "decoder":
            fan_in = int(np.prod(core[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.02 * rng.randn(*shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# the trainer tests (tests/test_torch_trainer*.py, test_torch_train_sft.py)
# ---------------------------------------------------------------------------

JTRAIN, TTRAIN = train_config(jcfg), train_config(tcfg)


def sft_records(root):
    """12 LLaVA-format records under ``root``: 8 with distinct images (JPEG
    and PNG, 2:1 to 1:2), 4 text-only, answers of 10-60 bytes; returns
    (json path, image folder)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    records = []
    for i in range(12):
        answer = " ".join(["caption", str(i)] + ["word"] * (i * 4 % 11))
        rec = {"id": str(i), "conversations": [
            {"from": "human", "value": "Describe it."},
            {"from": "gpt", "value": answer}]}
        if i % 3:
            w, h = 64 + 16 * (i % 5), 128 - 8 * (i % 4)
            arr = (rng.rand(h, w, 3) * 64 + np.linspace(0, 190, w)[None, :,
                                                            None]).astype(
                np.uint8)
            name = f"{i}.jpg" if i % 2 else f"{i}.png"
            Image.fromarray(arr).save(root / name, quality=95)
            rec["image"] = name
            rec["conversations"][0]["value"] = "<image>\nDescribe it."
        records.append(rec)
    path = root / "data.json"
    path.write_text(json.dumps(records))
    return str(path), str(root)


def pin_image_loaders(monkeypatch) -> bool:
    """Put both packages' JPEG loaders on one path for the test's duration:
    native on both where both libraries load, PIL on both otherwise (each
    module's ``_lib`` / ``_tried`` patched). A loader whose earlier load
    failed is tried once more first: JAX's builds its library in place
    under ``native/``, and a process that loads it while another builds it
    fails for good. Returns whether the loaders are native."""
    for mod in (jni, tni):
        if mod._lib is None:
            monkeypatch.setattr(mod, "_tried", False)
    native = jni.available() and tni.available()
    if not native:
        for mod in (jni, tni):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    return native


@pytest.fixture(autouse=True)
def same_image_loader(monkeypatch):
    """Every test that imports this fixture compares batches decoded by one
    loader in both packages (``pin_image_loaders``)."""
    return pin_image_loaders(monkeypatch)


def sft_datasets(data):
    """(port dataset, JAX dataset) over ``sft_records``' files; tests that
    call it use the ``same_image_loader`` fixture."""
    path, folder = data
    t = tsft.SupervisedDataset(
        tsft.DataArguments(data_path=path, image_folder=folder),
        preprocessing.ByteTokenizer(), preprocessing.ImageProcessor(128))
    j = jsft.SupervisedDataset(
        jsft.DataArguments(data_path=path, image_folder=folder),
        jpreprocessing.ByteTokenizer(), jpreprocessing.ImageProcessor(128))
    return t, j


TRAIN_ARGS = dict(batch_size=4, max_steps=8, learning_rate=1e-3,
                  log_steps=4, save_steps=0, warmup_ratio=0.25,
                  weight_decay=0.01, seed=0)


def trainers(data, out, np_params=None, **kw):
    """(JAX trainer, port trainer) over the same init and records. A LoRA
    run carries JAX's adapters (drawn by jax.random) into the port."""
    np_params = live_weights(JTRAIN) if np_params is None else np_params
    tds, jds = sft_datasets(data)
    args = {**TRAIN_ARGS, **kw}
    jt = jtrainer.Trainer(JTRAIN, jax.tree.map(jnp.asarray, np_params), jds,
                          jtrainer.TrainingArguments(
                              output_dir=os.path.join(out, "jax"), **args))
    tr = ttrainer.Trainer(TTRAIN, from_jax_params(np_params, TTRAIN), tds,
                          ttrainer.TrainingArguments(
                              output_dir=os.path.join(out, "port"), **args),
                          device="cpu")
    if args.get("lora_enable"):
        start = from_jax_params(jax.tree.map(np.asarray, jt.state.params),
                                TTRAIN)
        _copy_adapters(tr.state.params, start)
    return jt, tr


def _copy_adapters(dst, src):
    from fastvlm_tpu_torch.train.step import named_leaves

    src = dict(named_leaves(src))
    with torch.no_grad():
        for path, x in named_leaves(dst):
            if "lora_" in path:
                x.copy_(src[path])


def assert_params_close(port_params, jax_params, rel=1e-4):
    """Each group's leaves within ``rel`` of the group's largest |value|."""
    want = from_jax_params(jax.tree.map(np.asarray, jax_params), TTRAIN)
    from fastvlm_tpu_torch.train.step import named_leaves

    for group in want:
        w = dict(named_leaves(want[group]))
        g = dict(named_leaves(port_params[group]))
        assert sorted(g) == sorted(w), group
        top = max(float(x.float().abs().max()) for x in w.values())
        for path, x in w.items():
            if not x.is_floating_point():
                assert torch.equal(g[path], x), path
                continue
            err = float((g[path].detach().float() - x.float()).abs().max())
            assert err <= rel * top, (group, path, err, top)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test's torch ops on one intra-op thread. The tiny training
    steps are thousands of small ops; with several test processes on the
    machine, intra-op threads only contend (a 60-step run took ~200x its
    solo time inside a parallel suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# gloo worlds (tests/test_torch_parallel_train.py, test_torch_pipeline.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_world():
    """A gloo process group of one rank for the test's duration, and its
    (1, 1) mesh."""
    from fastvlm_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(num_processes=1, device="cpu")
    try:
        yield make_mesh(dp=1, tp=1)
    finally:
        distributed.shutdown()


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


def start_world(root, n, scenarios, inputs, timeout=300):
    """Start ``tests/torch_parallel_worker.py`` on ``n`` gloo ranks (a
    ``file://`` rendezvous under ``root``) over ``inputs`` ({name: object},
    written as .npy files), and return at once; ``finish_world`` waits
    for it. The ranks are killed if any fails or the whole run outlasts
    ``timeout`` seconds from here."""
    in_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    for name, obj in inputs.items():
        np.save(os.path.join(in_dir, name + ".npy"), obj, allow_pickle=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(n), os.path.join(root, "store"),
         in_dir, out_dir, *scenarios], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return {"procs": procs, "out": out_dir, "scenarios": scenarios,
            "deadline": time.monotonic() + timeout}


def stop_world(world) -> None:
    """Kill the ranks still running (a no-op once ``finish_world`` ran)."""
    for p in world["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_world(world):
    """Wait for a ``start_world`` world; returns {scenario: [rank 0 result,
    ...]}, or raises with every rank's log tail if one failed."""
    procs = world["procs"]
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > world["deadline"]:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("gloo world failed:\n" + "\n".join(
            f"[rank {r} rc {p.returncode}] {log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return {s: [torch.load(os.path.join(world["out"], f"{s}.rank{r}.pt"),
                           weights_only=False) for r in range(len(procs))]
            for s in world["scenarios"]}


def run_world(root, n, scenarios, inputs, timeout=300):
    """``start_world`` then ``finish_world``."""
    return finish_world(start_world(root, n, scenarios, inputs, timeout))
