"""The port's trainer (fastvlm_tpu_torch/train/trainer.py) against the JAX
package's, in f32 on the tiny training config (live tower) and the
12-record synthetic set of ``torch_tiny.sft_records``: ``Trainer.train``
for 8 steps from the same init and data under the default freeze,
``unfreeze_mm_vision_tower``, ``tune_mm_mlp_adapter`` and LoRA. The final
loss within 1e-4 relative of JAX's, and the final params within 1e-4 of
each group's largest |value| (the two packages compute their gradients
independently; Adam's g / |g| passes their f32 noise through at the lr's
scale)."""

import numpy as np
import pytest
import torch

from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_tiny as tt
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tiny import same_image_loader  # noqa: F401 (autouse fixture)

JC, TC = tt.JTRAIN, tt.TTRAIN


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tt.sft_records(tmp_path_factory.mktemp("sft"))


@pytest.mark.parametrize("mode", ["default", "unfreeze_tower",
                                  "tune_adapter", "lora"])
def test_train_equals_jax(data, tmp_path, mode):
    kw = {"default": {}, "unfreeze_tower": {"unfreeze_mm_vision_tower": True,
                                            "mm_vision_tower_lr": 3e-4},
          "tune_adapter": {"tune_mm_mlp_adapter": True},
          "lora": {"lora_enable": True, "lora_r": 4}}[mode]
    np_params = tt.live_weights(JC)
    jt, tr = tt.trainers(data, str(tmp_path), np_params, **kw)
    want = jt.train()
    got = tr.train()
    assert got["steps"] == want["steps"] == 8
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    tt.assert_params_close(tr.state.params, jt.state.params)
    before = from_jax_params(np_params, TC)
    frozen = {"default": ["vision"], "unfreeze_tower": [],
              "tune_adapter": ["vision", "decoder"],
              "lora": ["vision", "projector"]}[mode]
    for group in frozen:
        for (path, x), (_, b) in zip(tstep.named_leaves(tr.state.params[group]),
                                     tstep.named_leaves(before[group])):
            assert torch.equal(x, b), (group, path)
    assert [h["step"] for h in tr.history] == list(range(1, 9))
    assert [h["loss"] is not None for h in tr.history] == [
        s % 4 == 0 for s in range(1, 9)]
