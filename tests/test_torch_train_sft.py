"""The trainer's refusals, the train_sft CLI (``--random-tiny --device
cpu``, the unported flags refused, the default device needing a card) and
a trained tiny model generating through the port's ``Engine``."""

import json
import os

import pytest
import torch

from fastvlm_tpu_torch.data import sft as tsft
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer, ImageProcessor
from fastvlm_tpu_torch.train import train_sft
from fastvlm_tpu_torch.train import trainer as ttrainer
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_tiny as tt
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)

JC, TC = tt.JTRAIN, tt.TTRAIN


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tt.sft_records(tmp_path_factory.mktemp("sft"))


def test_trainer_refuses_unported_schedules(data):
    tds, _ = tt.sft_datasets(data)
    params = from_jax_params(tt.live_weights(JC), TC)
    args = ttrainer.TrainingArguments()
    for kw in ({"mesh": object()}, {"pp_micro": 2}, {"seq_parallel": True}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ttrainer.Trainer(TC, params, tds, args, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttrainer.Trainer(TC, params, tds,
                         ttrainer.TrainingArguments(zero1=True), device="cpu")
    with pytest.raises(ValueError, match="needs --lora-enable"):
        ttrainer.Trainer(TC, params, tds,
                         ttrainer.TrainingArguments(bits=8), device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_sft_random_tiny_runs_on_the_cpu(data, tmp_path, capsys):
    path, folder = data
    out = str(tmp_path / "run")
    rc = train_sft.main(["--random-tiny", "--device", "cpu", "--data-path",
                         path, "--image-folder", folder, "--output-dir", out,
                         "--max-steps", "3", "--batch-size", "4",
                         "--log-steps", "1"])
    assert rc == 0
    assert "'steps': 3" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "checkpoint-3"))) == [
        "opt_state", "params"]


@pytest.mark.parametrize("flags", [
    ["--tp", "2"], ["--sp"], ["--pp-micro", "2"], ["--zero1"], ["--fsdp"],
    ["--multihost"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"]],
    ids=lambda f: f[0])
def test_unported_flags_exit_not_yet_ported(data, tmp_path, capsys, flags):
    path, _ = data
    rc = train_sft.main(["--random-tiny", "--device", "cpu", "--data-path",
                         path, "--output-dir", str(tmp_path)] + flags)
    assert rc == 2
    assert "not yet ported, see ROADMAP.md" in capsys.readouterr().err


def test_default_device_needs_a_card(data, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    path, _ = data
    rc = train_sft.main(["--random-tiny", "--data-path", path,
                         "--output-dir", str(tmp_path)])
    assert rc == 1
    assert "--device cpu" in capsys.readouterr().err


def test_trained_tiny_model_generates_its_caption(tmp_path):
    """The short form of tests/test_full_circle.py: train the tiny model on
    one caption, save, restore the native bundle, and generate the caption
    through the port's Engine."""
    from PIL import Image

    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.utils.checkpoint import restore_native

    Image.new("RGB", (100, 80), (10, 200, 30)).save(tmp_path / "x.jpg")
    records = [{"id": str(i), "image": "x.jpg", "conversations": [
        {"from": "human", "value": "<image>\nDescribe."},
        {"from": "gpt", "value": "green box"}]} for i in range(8)]
    (tmp_path / "data.json").write_text(json.dumps(records))
    tok = ByteTokenizer()
    ds = tsft.SupervisedDataset(
        tsft.DataArguments(data_path=str(tmp_path / "data.json"),
                           image_folder=str(tmp_path)),
        tok, ImageProcessor(128))
    cfg = train_sft.tiny_config()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = vlm.init(gen, cfg)
    args = ttrainer.TrainingArguments(
        output_dir=str(tmp_path / "run"), batch_size=4, max_steps=60,
        learning_rate=5e-3, save_steps=0, log_steps=20, warmup_ratio=0.0)
    result = ttrainer.Trainer(cfg, params, ds, args, device="cpu").train()
    assert result["final_loss"] < 0.3, result
    restored = restore_native(str(tmp_path / "run" / "checkpoint-60"
                                  / "params"), params)
    engine = Engine(cfg, restored, tok, eos_ids=(tok.eos_token_id,))
    text, _ = engine.chat("Describe.", Image.open(tmp_path / "x.jpg"),
                          max_new_tokens=12)
    assert "green box" in text, text
