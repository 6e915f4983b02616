"""A configuration's decoder family (``family.py``): the dense Qwen2 module
by default, giving the numbers that the harness gave before the decoder
came from a module (``data/dense_values.json`` and the two
``data/dense_logits_*.npy``, written by the same calls at commit 5be15e8,
where this code lay in ``weights.py``, ``reference.py``, ``flops.py`` and
the K4 reader); and a second family, the test's Mistral module, whose
reference is transformers' Mistral to rounding, which the check holds the
port to in both tiny burst cells, and which the dense module's reference
does not pass."""

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from port_bench import family, flops, harness, loadgen, weights

DATA = os.path.join(os.path.dirname(__file__), "data")
BEFORE = json.load(open(os.path.join(DATA, "dense_values.json")))
CELLS = ("vqa-shared", "vqa-unshared")
H100 = "NVIDIA H100 80GB HBM3"


def config(name):
    return harness.load_json(os.path.join(DATA, name))


BIG = harness.load_json(os.path.join(harness.HERE, "configs",
                                     "fastvlm-1.5b.json"))
k4_bound_s = loadgen.module("metrics", "k4_roofline.burst").call_bound_s


def test_the_default_family_is_the_dense_module():
    assert "decoder" not in config("tiny.json")
    assert BIG["decoder"] == family.DEFAULT
    dense = family.of(config("tiny.json"))
    assert family.of(BIG) is dense
    assert family.of(config("tiny-mistral.json")) is not dense
    with pytest.raises(FileNotFoundError):
        family.of({"decoder": "port_bench/decoders/absent.py"})


def _digest(tree) -> str:
    """sha256 over every leaf's path, shape, dtype and bytes, in order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            t = node.detach().contiguous().cpu()
            h.update(f"{path}|{tuple(t.shape)}|{t.dtype}|".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(BEFORE["tree_sha256"]))
def test_the_drawn_tree_is_unchanged(key):
    seed, dtype = key.split(".")
    tree = weights.draw(config("tiny.json"), int(seed), "cpu",
                        getattr(torch, dtype))
    assert _digest(tree) == BEFORE["tree_sha256"][key]


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_reference_and_control_logits_are_unchanged(quant):
    cfg, at = config("tiny.json"), BEFORE["logits"]
    tree = weights.draw(cfg, at["seed"], "cpu", torch.bfloat16)
    s = cfg["vision"]["image_size"]
    img = np.random.default_rng(at["image_rng"]).integers(
        0, 256, (s, s, 3), np.uint8)
    ids, image_at = loadgen.prompt_ids(at["prompt"], flops.image_tokens(cfg))
    assert image_at == at["image_at"]
    with torch.inference_mode():
        got = family.of(cfg).Reference(cfg, tree, quant=quant).logits(
            ids, torch.as_tensor(img), image_at, at["rows"])
    want = torch.as_tensor(np.load(os.path.join(
        DATA, f"dense_logits_{quant or 'f32'}.npy")))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["tiny", "fastvlm-1.5b"])
def test_port_config_is_unchanged(name):
    cfg = BIG if name == "fastvlm-1.5b" else config("tiny.json")
    got = json.loads(json.dumps(dataclasses.asdict(harness.port_config(cfg))))
    assert got == BEFORE["port_config"][name]


def test_counts_at_1_5b_are_unchanged():
    count = family.of(BIG).flops
    for new, cached, head_rows, want in BEFORE["fastvlm-1.5b"][
            "decoder_flops"]:
        assert count(BIG, new, cached, head_rows) == want
    peak = flops.PEAKS[H100]
    for info, want in BEFORE["fastvlm-1.5b"]["k4_call_bound_s"]:
        assert k4_bound_s(BIG, info, peak) == want


def test_k4_bound_clips_each_layer_to_its_window():
    cfg = config("tiny-mistral.json")  # 2 layers, 4 / 2 heads of 16, W 40
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1.0}  # bytes bound it
    info = {"lens": [30, 1], "starts": [3, -1], "offset": 100,
            "images": True}
    # 30 queries after 100 keys each see 40; they read keys 61..129
    assert k4_bound_s(cfg, info, peak) == 2 * 2 * (
        2 * 30 * 4 * 16 + 2 * 69 * 2 * 16)
    peak = {"bf16_flops": 1.0, "hbm_bytes": 1e12}  # operations bound it
    assert k4_bound_s(cfg, info, peak) == 2 * 4 * 4 * 16 * 30 * 40


def test_the_mistral_reference_is_transformers_mistral():
    """The test family's reference, written from Mistral's description,
    against ``transformers``' own ``MistralForCausalLM`` on the same
    weights, 100 positions under a 40-key window."""
    tr = pytest.importorskip("transformers")
    cfg = config("tiny-mistral.json")
    tree = weights.draw(cfg, 7, "cpu", torch.float32)
    dec = tree["decoder"]
    hf = tr.MistralConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        sliding_window=cfg["sliding_window"], tie_word_embeddings=False)
    hf._attn_implementation = "eager"
    model = tr.MistralForCausalLM(hf).eval()
    sd = {"model.embed_tokens.weight": dec["embed"],
          "model.norm.weight": dec["final_norm"],
          "lm_head.weight": dec["lm_head"]["w"].t()}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i, lp in enumerate(dec["layers"]):
        at = f"model.layers.{i}."
        sd.update({at + n + ".weight": lp[k]["w"].t()
                   for k, n in names.items()})
        sd[at + "input_layernorm.weight"] = lp["ln1"]
        sd[at + "post_attention_layernorm.weight"] = lp["ln2"]
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()},
                          strict=True)
    x = torch.randn(100, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(0))
    ref = family.of(cfg).Reference(cfg, tree)
    with torch.no_grad():
        want = model(inputs_embeds=x[None]).logits[0]
        got = ref.head(ref.hidden(x))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _bench(cfg_file):
    real = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    return {"configs": [{"name": "c", "file": cfg_file}],
            "workloads": [{"name": f"c.{c}", "config": "c",
                           "traffic": f"tiny-{c}", "chips": 1}
                          for c in CELLS],
            "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                           for m in real["end_to_end"]],
            "per_layer": []}


def _run(cfg_file, cell, seed=20260102):
    torch.set_num_threads(2)
    served = harness.serve(_bench(cfg_file), f"c.{cell}", seed, 3.0, False,
                           t_process=time.perf_counter(), device="cpu",
                           traffic_dir=os.path.join(DATA, "traffic"),
                           log=lambda m: None)
    return harness.judge(served, seed, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_second_family_is_checked_against_its_own_reference(cell,
                                                               tmp_path):
    """The port's sliding window (``build_decoder_config``'s, from the
    file's ``sliding_window``) passes the Mistral module's reference;
    the same configuration naming the dense module does not pass."""
    own = _run("port_bench/tests/data/tiny-mistral.json", cell)
    assert own["correct"], own["limits"]
    dense = dict(config("tiny-mistral.json"), decoder=family.DEFAULT)
    path = tmp_path / "tiny-mistral-dense.json"
    path.write_text(json.dumps(dense))
    other = _run(str(path), cell)
    assert not other["correct"], other["limits"]
    assert other["limits"]["mean_logit_gap"]["value"] > \
        10 * other["limits"]["mean_logit_gap"]["limit"]
