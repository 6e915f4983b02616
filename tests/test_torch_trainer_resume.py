"""Save, resume and QLoRA in the port's trainer against the JAX package's
(tiny training config, ``torch_tiny.sft_records``), with the reference's
gaps pinned: a resumed run restarts the sampler at epoch 0, LoRA and
adapter-only checkpoints carry no optimizer state, and the LoRA optimizer
ignores warmup. Params and losses within 1e-4 as in
tests/test_torch_trainer.py; QLoRA's loss within 1e-3 (its int8 base's
products round differently in the two packages)."""

import os

import jax
import numpy as np
import pytest
import torch

from fastvlm_tpu.train import trainer as jtrainer
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.train import trainer as ttrainer
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_tiny as tt
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tiny import same_image_loader  # noqa: F401 (autouse fixture)

JC, TC = tt.JTRAIN, tt.TTRAIN


def tt_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tt.sft_records(tmp_path_factory.mktemp("sft"))


def test_save_then_resume_equals_jax_and_restarts_at_epoch_0(data, tmp_path):
    """4 steps saving every 2, then a fresh trainer over the same directory
    with max_steps 6 resumes at 4 and trains 2 more. Params, optimizer
    state and step equal JAX's, and both samplers restart at epoch 0 (the
    reference's gap: steps 5-6 re-read the first epoch's batches)."""
    np_params = tt.live_weights(JC, seed=1)
    jt, tr = tt.trainers(data, str(tmp_path), np_params, max_steps=4,
                       save_steps=2)
    jt.train()
    tr.train()
    ckpt = os.path.join(str(tmp_path), "port", "checkpoint-4")
    assert sorted(os.listdir(ckpt)) == ["opt_state", "params"]
    assert os.path.isdir(os.path.join(str(tmp_path), "port", "checkpoint-2"))
    jt2, tr2 = tt.trainers(data, str(tmp_path), np_params, max_steps=6,
                         save_steps=2)
    # the restored state: tr's params and moments, bitwise
    assert tr2.resume() == 4 and tr2.state.step == 4
    for (p, a), (_, b) in zip(tstep.named_leaves(tr2.state.params),
                              tstep.named_leaves(tr.state.params)):
        assert torch.equal(a.detach(), b.detach()), p
    for (p, a), (_, b) in zip(tstep.named_leaves(tr2.state.opt_state),
                              tstep.named_leaves(tr.state.opt_state)):
        assert torch.equal(a, b), p
    want = jt2.train()
    got = tr2.train()
    assert got["steps"] == want["steps"] == 6
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    tt.assert_params_close(tr2.state.params, jt2.state.params)
    assert int(tr2.state.opt_state["count"]) == 6
    assert tr2.sampler.epoch == jt2.sampler.epoch == 1


def test_resume_rereads_the_first_batches_like_jax(data, tmp_path):
    """After a resume the sampler is at epoch 0 again, so the first batch
    trained is the fresh run's first batch; JAX's resume never touches its
    sampler either."""
    np_params = tt.live_weights(JC, seed=4)
    _, tr = tt.trainers(data, str(tmp_path), np_params, max_steps=3,
                      save_steps=3, tune_mm_mlp_adapter=True)
    tr.train()
    jt2, tr2 = tt.trainers(data, str(tmp_path), np_params, max_steps=5,
                         tune_mm_mlp_adapter=True)
    assert tr2.resume() == 3
    assert tr2.sampler.epoch == jt2.sampler.epoch == 0
    tds, jds = tt.sft_datasets(data)
    first = next(ttrainer.batches(tr2.dataset, tr2.sampler, 4,
                                  TC.num_image_tokens))
    fresh = next(jtrainer.batches(jds, jtrainer.LengthGroupedSampler(
        jds.lengths, 4, seed=0), 4, JC.num_image_tokens))
    for k in fresh:
        assert np.array_equal(first[k], fresh[k]), k


@pytest.mark.parametrize("mode", ["tune_adapter", "lora"])
def test_adapter_and_lora_checkpoints_carry_no_optimizer_state_like_jax(
        data, tmp_path, mode):
    kw = ({"tune_mm_mlp_adapter": True} if mode == "tune_adapter"
          else {"lora_enable": True, "lora_r": 4})
    np_params = tt.live_weights(JC, seed=2)
    _, tr = tt.trainers(data, str(tmp_path), np_params, max_steps=3, **kw)
    tr.train()
    ckpt = os.path.join(str(tmp_path), "port", "checkpoint-3")
    want_dir = "mm_projector" if mode == "tune_adapter" else "lora_adapters"
    assert os.listdir(ckpt) == [want_dir]
    _, tr2 = tt.trainers(data, str(tmp_path), np_params, max_steps=4, **kw)
    assert tr2.resume() == 3
    # the trained leaves come back; the moments restart from zero
    for (p, a), (_, b) in zip(tstep.named_leaves(tr2.state.params),
                              tstep.named_leaves(tr.state.params)):
        assert torch.equal(a.detach(), b.detach()), p
    assert int(tr2.state.opt_state["count"]) == 0
    assert all(float(m.abs().max()) == 0
               for m in tr2.state.opt_state["mu"].values())


def test_lora_optimizer_ignores_warmup_like_jax(data, tmp_path):
    """The LoRA optimizer's lr is constant from step 0 whatever
    warmup_ratio says (JAX's make_lora_optimizer takes no schedule)."""
    import inspect

    from fastvlm_tpu.train import lora as jlora

    assert "warmup" not in " ".join(
        inspect.signature(jlora.make_lora_optimizer).parameters)
    _, tr = tt.trainers(data, str(tmp_path), lora_enable=True, lora_r=4,
                      warmup_ratio=0.5, learning_rate=7e-4)
    group = tr.tx.groups["lora"]
    assert group.lr(0) == group.lr(100) == 7e-4


def test_qlora_trainer_matches_jax_base_and_changes_only_adapters(
        data, tmp_path):
    np_params = tt.live_weights(JC, seed=3)
    jt, tr = tt.trainers(data, str(tmp_path), np_params, lora_enable=True,
                       lora_r=4, bits=8, max_steps=2, log_steps=1)
    # the same int8 base in both packages
    base = dict(tstep.named_leaves(
        from_jax_params(tt_np(jt.state.params), TC)["decoder"]))
    ints = [(p, a) for p, a in tstep.named_leaves(tr.state.params["decoder"])
            if not a.is_floating_point()]
    assert ints
    for p, a in ints:
        assert torch.equal(a, base[p]), p
    before = {p: x.detach().clone()
              for p, x in tstep.named_leaves(tr.state.params)}
    want = jt.train()
    got = tr.train()
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-3)
    for p, x in tstep.named_leaves(tr.state.params):
        if "lora_" not in p:
            assert torch.equal(x.detach(), before[p]), p
    ckpt = os.path.join(str(tmp_path), "port", "checkpoint-2")
    assert os.listdir(ckpt) == ["lora_adapters"]
