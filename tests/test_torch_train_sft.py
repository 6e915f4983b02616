"""The trainer's parallel schedules and refusals, the train_sft CLI
(``--random-tiny --device cpu``, each parallel flag in a one-rank gloo
world or refused with JAX's error, the default device needing a card) and
a trained tiny model generating through the port's ``Engine``."""

import json
import os
import socket

import pytest
import torch
import torch.distributed as dist

from fastvlm_tpu_torch.data import sft as tsft
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer, ImageProcessor
from fastvlm_tpu_torch.train import train_sft
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.train import trainer as ttrainer
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_tiny as tt
from torch_tiny import one_rank_world  # noqa: F401 (fixture)
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tiny import same_image_loader  # noqa: F401 (autouse fixture)

JC, TC = tt.JTRAIN, tt.TTRAIN


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tt.sft_records(tmp_path_factory.mktemp("sft"))


def test_trainer_refuses_unported_schedules(data, one_rank_world):
    """Every schedule builds on a one-rank mesh (the refusals that stood
    here before the parallel port are gone); what the Trainer refuses is
    JAX's: --bits without LoRA, and (the port's own) pp_micro without a
    mesh and a batch that dp does not divide."""
    tds, _ = tt.sft_datasets(data)
    params = from_jax_params(tt.live_weights(JC), TC)
    args = ttrainer.TrainingArguments()
    mesh = one_rank_world
    for kw in ({"mesh": mesh}, {"mesh": mesh, "pp_micro": 2},
               {"mesh": mesh, "seq_parallel": True}):
        tr = ttrainer.Trainer(TC, params, tds, args, device="cpu", **kw)
        assert tr.state.layout is not None and tr.state.layout.mesh is mesh
    tr = ttrainer.Trainer(TC, params, tds, ttrainer.TrainingArguments(
        zero1=True), mesh=mesh, device="cpu")
    assert set(tr.state.opt_state["mu"]) == set(
        p for p, x in tstep.named_leaves(tr.state.params) if x.requires_grad)
    with pytest.raises(ValueError, match="pass mesh="):
        ttrainer.Trainer(TC, params, tds, args, pp_micro=2, device="cpu")
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


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


@pytest.mark.parametrize("flag", [
    "--tp", "--sp", "--pp-micro", "--zero1", "--fsdp", "--multihost",
    "--coordinator", "--num-processes", "--process-id"])
def test_unported_flags_exit_not_yet_ported(data, tmp_path, capsys,
                                            monkeypatch, flag):
    """The nine parallel flags, once refused with exit 2, run one step in a
    one-rank gloo world (made for the mesh flags; from torchrun's env, a
    ``file://`` rendezvous or an in-memory store for the launch flags) and
    take it down after; ``--tp 2`` and ``--pp-micro 2`` on one rank raise
    JAX's errors."""
    path, _ = data
    store = f"file://{tmp_path}/store"
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", _free_port())
    flags = {"--tp": ["--tp", "2"], "--sp": ["--sp"],
             "--pp-micro": ["--pp-micro", "2"], "--zero1": ["--zero1"],
             "--fsdp": ["--fsdp"], "--multihost": ["--multihost"],
             "--coordinator": ["--coordinator", store],
             "--num-processes": ["--multihost", "--num-processes", "1"],
             "--process-id": ["--coordinator", store, "--num-processes",
                              "1", "--process-id", "0"]}[flag]
    argv = ["--random-tiny", "--device", "cpu", "--data-path", path,
            "--output-dir", str(tmp_path / "run"), "--max-steps", "1",
            "--save-steps", "0"] + flags
    if flag == "--tp":
        with pytest.raises(ValueError, match="not divisible by tp=2"):
            train_sft.main(argv)
    elif flag == "--pp-micro":
        with pytest.raises(SystemExit) as exit_:
            train_sft.main(argv)
        assert exit_.value.code == 2
        assert "--pp-micro needs --tp > 1" in capsys.readouterr().err
    else:
        assert train_sft.main(argv) == 0
        assert "'steps': 1" in capsys.readouterr().out
    assert not dist.is_initialized()


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
