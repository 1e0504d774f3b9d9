"""The port's FullSubNet+ training step against the JAX package on the CPU:
loss and gradients, the optimizer (optax's clip, Adam/AdamW, the EMA
warmup), three whole steps, gradient accumulation, the bf16 route through
LSTMScan, and the trainer's checkpoint resume; and the same loss, gradients
and one Adam step for FullSubNet v1 (`model_type="fullsubnet"`) with GRU and
LSTM bodies, with the bf16 route through GRUScan.

Narrow model (32 freqs, sub-band hidden 8, as tests/test_training.py builds
one), batch 4, float32 unless a test says bf16. Weights come from the JAX
`init` through generative_audio_torch.utils.convert; gradients and updated
parameters go back through its inverse and are compared leaf by leaf.

Tolerances. Both sides are float32 with sums in another order, so a loss
agrees to 1e-5 relative. A gradient leaf agrees to 1e-3 of its own peak
plus 1e-4 of the largest peak of any leaf: some leaves (a bias in front of
a normalisation, for one) have gradients that cancel analytically, and what
is left of them is rounding noise of the large terms (measured up to
3e-5 of the largest peak, for the SI-SNR loss). Adam divides by |g|,
so after a step such an element may have moved by the learning rate in
either direction in either framework; parameters are therefore compared
where the first step's gradient is above 1e-4 of the global peak (within 2%
of the learning rate), and everywhere through the first-order effect of
the difference on the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from generative_audio_tpu import train as JT
from generative_audio_tpu.models import FullSubNetPlusConfig as JaxModelConfig
from generative_audio_tpu.models.fullsubnet import (
    FullSubNetConfig as JaxV1Config)
from generative_audio_tpu.train.state import create_train_state
from generative_audio_tpu.train.state import make_optimizer as jax_optimizer
from generative_audio_torch import train as TT
from generative_audio_torch.models import (
    FullSubNetConfig, FullSubNetPlusConfig)
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
LR = 1e-3


def _configs(loss_type="mse", loss_alpha=0.0, groups=2, dtype="float32"):
    model = dict(num_freqs=32, sb_num_neighbors=2, fb_model_hidden_size=16,
                 sb_model_hidden_size=16 if dtype == "bfloat16" else 8,
                 num_groups_in_drop_band=groups)
    kw = dict(n_fft=62, hop_length=32, win_length=62, compute_dtype=dtype,
              loss_type=loss_type, loss_alpha=loss_alpha)
    return (JT.EnhanceTrainConfig(model=JaxModelConfig(**model), **kw),
            TT.EnhanceTrainConfig(model=FullSubNetPlusConfig(**model), **kw))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((4, 2048)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((4, 2048)).astype(np.float32)
    return noisy, clean


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_state(tcfg, jax_params):
    state = TT.init_enhance_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(convert.convert_fullsubnet_plus(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    return state


def _port_params(state):
    return _leaves(convert.to_jax_fullsubnet_plus(state.model.state_dict()))


@pytest.mark.parametrize("loss_type,loss_alpha", [
    ("mse", 0.0), ("l1", 0.0), ("si_snr", 0.0), ("si_snr_wave", 0.0),
    ("mse", 0.3)])
def test_loss_and_gradients_match_jax(loss_type, loss_alpha):
    jcfg, tcfg = _configs(loss_type, loss_alpha)
    noisy, clean = _batch()
    params = JT.init_enhance_state(jcfg, jax.random.PRNGKey(0)).params
    want, want_grads = jax.value_and_grad(JT.enhance_loss_fn)(
        params, noisy, clean, jcfg)
    state = _port_state(tcfg, params)
    got = TT.enhance_loss_fn(state.model, torch.from_numpy(noisy),
                             torch.from_numpy(clean), tcfg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got_grads = _leaves(convert.to_jax_fullsubnet_plus(grads))
    want_grads = _leaves(want_grads)
    assert set(got_grads) == set(want_grads)
    peak = max(np.abs(w).max() for w in want_grads.values())
    for key, w in want_grads.items():
        np.testing.assert_allclose(
            got_grads[key], w, rtol=0,
            atol=1e-3 * np.abs(w).max() + 1e-4 * peak, err_msg=key)


def _v1_configs(kind, loss_type="mse", loss_alpha=0.0, dtype="float32"):
    """FullSubNet v1 at the width tests/test_training.py trains it at."""
    model = dict(num_freqs=32, sb_num_neighbors=2, fb_model_hidden_size=16,
                 sb_model_hidden_size=16 if dtype == "bfloat16" else 8,
                 sequence_model=kind)
    kw = dict(model_type="fullsubnet", n_fft=62, hop_length=32, win_length=62,
              compute_dtype=dtype, loss_type=loss_type, loss_alpha=loss_alpha)
    return (JT.EnhanceTrainConfig(model_v1=JaxV1Config(**model), **kw),
            TT.EnhanceTrainConfig(model_v1=FullSubNetConfig(**model), **kw))


def _v1_port_state(tcfg, jax_params):
    state = TT.init_enhance_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(convert.convert_fullsubnet(
        jax.tree_util.tree_map(np.asarray, jax_params),
        tcfg.model_v1.sequence_model))
    return state


@pytest.mark.parametrize("kind,loss_type,loss_alpha", [
    ("GRU", "mse", 0.0), ("LSTM", "mse", 0.0), ("GRU", "si_snr_wave", 0.0),
    ("GRU", "mse", 0.3), ("LSTM", "l1", 0.0)])
def test_fullsubnet_loss_and_gradients_match_jax(kind, loss_type, loss_alpha):
    """model_type="fullsubnet": the magnitude-only call, num_groups from
    model_v1 (2: the drop_band branch) and the two full-band objectives."""
    jcfg, tcfg = _v1_configs(kind, loss_type, loss_alpha)
    noisy, clean = _batch()
    params = JT.init_enhance_state(jcfg, jax.random.PRNGKey(0)).params
    want, want_grads = jax.value_and_grad(JT.enhance_loss_fn)(
        params, noisy, clean, jcfg)
    state = _v1_port_state(tcfg, params)
    assert type(state.model).__name__ == "FullSubNet"
    got = TT.enhance_loss_fn(state.model, torch.from_numpy(noisy),
                             torch.from_numpy(clean), tcfg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got_grads = _leaves(convert.to_jax_fullsubnet(grads))
    want_grads = _leaves(want_grads)
    assert set(got_grads) == set(want_grads)
    peak = max(np.abs(w).max() for w in want_grads.values())
    for key, w in want_grads.items():
        np.testing.assert_allclose(
            got_grads[key], w, rtol=0,
            atol=1e-3 * np.abs(w).max() + 1e-4 * peak, err_msg=key)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_fullsubnet_adam_step_matches_jax(kind):
    """One whole train step of model_type="fullsubnet" against
    make_enhance_train_step in JAX, with the first-gradient rule of
    test_three_steps_match_jax."""
    jcfg, tcfg = _v1_configs(kind)
    noisy, clean = _batch()
    jstate = JT.init_enhance_state(jcfg, jax.random.PRNGKey(0))
    start = _leaves(jstate.params)
    tstate = _v1_port_state(tcfg, jstate.params)

    TT.enhance_loss_fn(tstate.model, torch.from_numpy(noisy),
                       torch.from_numpy(clean), tcfg).backward()
    grads = {k: p.grad for k, p in tstate.model.named_parameters()}
    first_grad = {k: np.abs(v) for k, v in
                  _leaves(convert.to_jax_fullsubnet(grads)).items()}
    tstate.optimizer.zero_grad()
    peak = max(g.max() for g in first_grad.values())

    jstate, want_loss = JT.make_enhance_train_step(jcfg, donate=False)(
        jstate, noisy, clean)
    tstate, got_loss = TT.make_enhance_train_step(tcfg)(tstate, noisy, clean)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert tstate.step == int(jstate.step) == 1
    want = _leaves(jstate.params)
    got = _leaves(convert.to_jax_fullsubnet(tstate.model.state_dict()))
    effect = moved = 0.0
    for key, w in want.items():
        diff = np.abs(got[key] - w)
        assert diff.max() <= 2 * LR + 1e-6, key             # Adam's own bound
        clear = first_grad[key] > 1e-4 * peak
        if clear.any():
            assert diff[clear].max() <= 0.02 * LR, key
        effect += float((first_grad[key] * diff).sum())
        moved += float((first_grad[key] * np.abs(w - start[key])).sum())
    assert effect <= 1e-3 * moved, (effect, moved)


def test_fullsubnet_bf16_route_trains_through_gru_scan():
    """compute_dtype bf16 on the CPU goes through GRUScan with the plain
    versions of the GRU kernels, full-band and sub-band. Its gradient agrees
    with the float32 model's per parameter tensor that carries the gradient
    (the limits of test_bf16_route_trains_and_agrees_with_float32), every
    W_hh and b_hh gets one, and the loss falls over five steps."""
    _, cfg16 = _v1_configs("GRU", dtype="bfloat16")
    cfg32 = TT.EnhanceTrainConfig(**{**cfg16.__dict__, "compute_dtype": "float32"})
    noisy, clean = (torch.from_numpy(x) for x in _batch())
    s16 = TT.init_enhance_state(cfg16, seed=4, device="cpu")
    s32 = TT.init_enhance_state(cfg32, seed=4, device="cpu")
    s32.model.load_state_dict(s16.model.state_dict())
    grads = []
    for state, cfg in ((s16, cfg16), (s32, cfg32)):
        TT.enhance_loss_fn(state.model, noisy, clean, cfg).backward()
        grads.append({k: p.grad.clone() for k, p in
                      state.model.named_parameters()})
        state.optimizer.zero_grad()
    top = max(g.norm().item() for g in grads[1].values())
    compared = 0
    for key, g32 in grads[1].items():
        g16 = grads[0][key]
        assert torch.isfinite(g16).all(), key
        if g32.norm().item() < 1e-3 * top:
            continue
        compared += 1
        cos = torch.nn.functional.cosine_similarity(
            g16.flatten(), g32.flatten(), dim=0).item()
        ratio = g16.norm().item() / g32.norm().item()
        assert cos > 0.98 and 0.9 < ratio < 1.1, (key, cos, ratio)
    assert compared >= 10
    for body in ("fb_model", "sb_model"):
        for n in (0, 1):
            for kind in ("weight_hh", "bias_hh"):
                key = f"{body}.sequence_model.{kind}_l{n}"
                assert grads[0][key].abs().max() > 0, key
    step = TT.make_enhance_train_step(cfg16)
    losses = [step(s16, noisy, clean)[1].item() for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("scale", [0.01, 30.0])     # below and above the clip
def test_clip_by_global_norm_is_optax(scale):
    rng = np.random.default_rng(1)
    grads = [(rng.standard_normal(s) * scale).astype(np.float32)
             for s in ((5, 7), (11,), (2, 3, 4))]
    want, _ = optax.clip_by_global_norm(10.0).update(grads, optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = TT.clip_by_global_norm_(got, 10.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)),
                               rtol=1e-6)
    assert (norm.item() > 10.0) == (scale > 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_optimizer_and_ema_match_jax_train_state(optimizer):
    """Four updates from given gradients: clip 1.0, Adam or AdamW, and the
    EMA with its 1/step warmup, against optax and the JAX TrainState."""
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    b0 = rng.standard_normal((4,)).astype(np.float32)
    tx = jax_optimizer(LR, (0.9, 0.99), weight_decay=0.1, clip_norm=1.0,
                       optimizer=optimizer)
    jstate = create_train_state({"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
                                tx, ema_decay=0.6)
    model = nn.ParameterDict({"w": nn.Parameter(torch.from_numpy(w0.copy())),
                              "b": nn.Parameter(torch.from_numpy(b0.copy()))})
    tstate = TT.TrainState(
        model, TT.make_optimizer(model.parameters(), LR, (0.9, 0.99),
                                 weight_decay=0.1, optimizer=optimizer),
        clip_norm=1.0, ema_decay=0.6)
    for step in range(4):
        scale = (0.05, 3.0, 0.5, 8.0)[step]     # the clip acts on some steps
        grads = {"w": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
                 "b": (rng.standard_normal((4,)) * scale).astype(np.float32)}
        jstate = jstate.apply_gradients(
            jax.tree_util.tree_map(jnp.asarray, grads))
        for k, p in model.items():
            p.grad = torch.from_numpy(grads[k].copy())
        tstate.apply_gradients()
        assert tstate.step == int(jstate.step) == step + 1
        for k in ("w", "b"):
            np.testing.assert_allclose(
                model[k].detach().numpy(), np.asarray(jstate.params[k]),
                atol=2e-7, rtol=1e-6, err_msg=f"{k} step {step}")
            np.testing.assert_allclose(
                tstate.ema_params[k].numpy(),
                np.asarray(jstate.ema_params[k]), atol=2e-7, rtol=1e-6)
        assert model["w"].grad is None


def test_three_steps_match_jax():
    """Three whole train steps (loss_alpha = 0.3, whose first gradient norm
    is above 10, so the clip acts) against make_enhance_train_step in JAX."""
    jcfg, tcfg = _configs("mse", 0.3)
    noisy, clean = _batch()
    jstate = JT.init_enhance_state(jcfg, jax.random.PRNGKey(0))
    start = _leaves(jstate.params)
    tstate = _port_state(tcfg, jstate.params)

    loss = TT.enhance_loss_fn(tstate.model, torch.from_numpy(noisy),
                              torch.from_numpy(clean), tcfg)
    loss.backward()
    grads = {k: p.grad for k, p in tstate.model.named_parameters()}
    assert TT.global_norm(grads.values()).item() > tcfg.clip_grad_norm
    first_grad = {k: np.abs(v) for k, v in
                  _leaves(convert.to_jax_fullsubnet_plus(grads)).items()}
    tstate.optimizer.zero_grad()
    peak = max(g.max() for g in first_grad.values())

    jstep = JT.make_enhance_train_step(jcfg, donate=False)
    tstep = TT.make_enhance_train_step(tcfg)
    for step in range(1, 4):
        jstate, want_loss = jstep(jstate, noisy, clean)
        tstate, got_loss = tstep(tstate, noisy, clean)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
        assert tstate.step == int(jstate.step) == step
        want, got = _leaves(jstate.params), _port_params(tstate)
        effect = moved = 0.0
        for key, w in want.items():
            diff = np.abs(got[key] - w)
            assert diff.max() <= 2 * LR * step + 1e-6, key   # Adam's own bound
            clear = first_grad[key] > 1e-4 * peak
            if clear.any():
                assert diff[clear].max() <= 0.02 * LR, (key, step)
            effect += float((first_grad[key] * diff).sum())
            moved += float((first_grad[key] * np.abs(w - start[key])).sum())
        assert effect <= 1e-3 * moved, (effect, moved)


def test_accumulated_step_equals_the_whole_batch():
    """accum_steps=2 against accum_steps=1 on the same batch, as
    tests/test_parity_extras.py::TestGradAccumulation holds it for JAX: the
    norm is per sample and the microbatches are of equal size, so the mean
    of their losses and gradients is the whole batch's (drop_band off: it
    needs a batch above its group count)."""
    _, tcfg = _configs(groups=1)
    noisy, clean = _batch()
    whole = TT.init_enhance_state(tcfg, seed=3, device="cpu")
    halves = TT.init_enhance_state(tcfg, seed=3, device="cpu")
    _, loss1 = TT.make_enhance_train_step(tcfg)(whole, noisy, clean)
    _, loss2 = TT.make_enhance_train_step(tcfg, accum_steps=2)(
        halves, noisy, clean)
    assert whole.step == halves.step == 1
    np.testing.assert_allclose(loss2.item(), loss1.item(), rtol=1e-5)
    # the JAX test's bound on the parameters after the one Adam update
    for (k, a), b in zip(whole.model.state_dict().items(),
                         halves.model.state_dict().values()):
        assert (a - b).abs().max().item() < 1e-5, k
    with pytest.raises(ValueError):
        TT.make_enhance_train_step(tcfg, accum_steps=3)(whole, noisy, clean)


def test_bf16_route_trains_and_agrees_with_float32():
    """compute_dtype bf16 on the CPU goes through LSTMScan with the plain
    versions of the training-forward and backward kernels. Its gradient
    agrees with the float32 model's per parameter tensor: cosine above 0.98
    and norm within 10%, for the tensors that carry the gradient (norm above
    1e-3 of the largest; bf16 keeps 8 bits, and the rest is noise in both).
    The loss falls over five steps on one fixed batch."""
    _, cfg16 = _configs(dtype="bfloat16")
    cfg32 = TT.EnhanceTrainConfig(**{**cfg16.__dict__, "compute_dtype": "float32"})
    noisy, clean = (torch.from_numpy(x) for x in _batch())
    s16 = TT.init_enhance_state(cfg16, seed=4, device="cpu")
    s32 = TT.init_enhance_state(cfg32, seed=4, device="cpu")
    s32.model.load_state_dict(s16.model.state_dict())
    grads = []
    for state, cfg in ((s16, cfg16), (s32, cfg32)):
        TT.enhance_loss_fn(state.model, noisy, clean, cfg).backward()
        grads.append({k: p.grad.clone() for k, p in
                      state.model.named_parameters()})
        state.optimizer.zero_grad()
    top = max(g.norm().item() for g in grads[1].values())
    compared = 0
    for key, g32 in grads[1].items():
        g16 = grads[0][key]
        assert torch.isfinite(g16).all(), key
        if g32.norm().item() < 1e-3 * top:
            continue
        compared += 1
        cos = torch.nn.functional.cosine_similarity(
            g16.flatten(), g32.flatten(), dim=0).item()
        ratio = g16.norm().item() / g32.norm().item()
        assert cos > 0.98 and 0.9 < ratio < 1.1, (key, cos, ratio)
    assert compared >= 10
    assert all(grads[0][f"sb_model.sequence_model.weight_hh_l{n}"].abs().max() > 0
               for n in (0, 1))

    step = TT.make_enhance_train_step(cfg16)
    losses = [step(s16, noisy, clean)[1].item() for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_enhance_trainer_resume(tmp_path):
    """Two epochs on a list loader write latest and step checkpoints; a fresh
    trainer's restore_latest resumes step, parameters, Adam state and
    best_score, and goes on training (the counterpart of
    tests/test_training.py::test_enhance_trainer_resume)."""
    _, cfg = _configs()
    noisy, clean = _batch()
    logged = []

    class Tracker:
        def log(self, scalars, step):
            logged.append((step, scalars))

    trainer = TT.EnhanceTrainer(cfg, checkpoint_dir=tmp_path / "ckpt",
                                tracker=Tracker(), device="cpu")
    trainer.best_score = 0.5
    trainer.train([(noisy, clean)] * 2, epochs=2, log=lambda *a: None)
    assert len(trainer.loss_history) == 2 and trainer.state.step == 4
    assert [s for s, _ in logged] == [2, 4] and "train_loss" in logged[0][1]
    assert trainer.ckpt.latest_step() == 4
    assert trainer.ckpt.path("latest").exists()
    assert trainer.ckpt.path("step_00000002").exists()
    assert trainer.ckpt.load_config()["loss_type"] == "mse"

    fresh = TT.EnhanceTrainer(cfg, checkpoint_dir=tmp_path / "ckpt", seed=9,
                              device="cpu")
    assert fresh.state.step == 0
    assert fresh.restore_latest()
    assert fresh.state.step == 4 and fresh.best_score == 0.5
    for (k, a), b in zip(trainer.state.model.state_dict().items(),
                         fresh.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    old, new = (t.state.optimizer.state_dict()["state"]
                for t in (trainer, fresh))
    assert set(old) == set(new) and len(old) > 0
    for idx in old:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(old[idx][name], new[idx][name])
    # the same next step from both
    a = trainer.train_epoch([(noisy, clean)])
    b = fresh.train_epoch([(noisy, clean)])
    assert fresh.state.step == 5 and a == b

    assert not TT.EnhanceTrainer(cfg, checkpoint_dir=tmp_path / "none",
                                 device="cpu").restore_latest()


def test_checkpoint_manager_best_and_partial_restore(tmp_path):
    ckpt = TT.CheckpointManager(tmp_path / "c", {"a": 1})
    assert ckpt.load_config() == {"a": 1}
    assert ckpt.restore("best") is None and ckpt.best_score() is None
    ckpt.save_best({"params": {"w": torch.ones(2)}}, 0.75, step=3,
                   extra={"probe_weight": 0.5, "note": "x"})
    assert ckpt.best_score() == 0.75
    assert ckpt.best_meta() == {"score": 0.75, "step": 3,
                                "probe_weight": 0.5, "note": "x"}
    target = {"params": {"w": torch.zeros(2), "new": torch.zeros(1)},
              "best_score": -1.0}
    with pytest.warns(UserWarning, match="partial restore"):
        merged = ckpt.restore("best", target, partial=True)
    assert torch.equal(merged["params"]["w"], torch.ones(2))
    assert torch.equal(merged["params"]["new"], torch.zeros(1))
    assert merged["best_score"] == -1.0
    with pytest.raises(KeyError):
        ckpt.restore("best", target, partial=False)


def test_config_and_trainer_refusals():
    with pytest.raises(ValueError):
        TT.EnhanceTrainConfig(loss_type="huber")
    with pytest.raises(ValueError):
        TT.EnhanceTrainConfig(loss_alpha=0.3, loss_type="l1")
    with pytest.raises(ValueError, match="unknown model_type"):
        TT.EnhanceTrainConfig(model_type="fullsubnet_v3")
    assert TT.EnhanceTrainConfig(model_type="fullsubnet").model_v1 == \
        FullSubNetConfig()
    default, jax_default = TT.EnhanceTrainConfig(), JT.EnhanceTrainConfig()
    for field in ("n_fft", "hop_length", "win_length", "learning_rate",
                  "betas", "clip_grad_norm", "compute_dtype", "loss_alpha",
                  "loss_type", "model_type"):
        assert getattr(default, field) == getattr(jax_default, field), field
    assert default.model.num_groups_in_drop_band == 2
    assert default.model_v1.__dict__ == jax_default.model_v1.__dict__
    trainer = TT.EnhanceTrainer(_configs()[1], device="cpu")
    # validation is ported (tests/test_torch_validation.py): a dataset with
    # nothing to score gives no WB_PESQ, and the composite falls back to
    # STOI's, here none, with a warning
    with pytest.warns(UserWarning, match="falls back to STOI"):
        assert trainer.validate([])["composite"] == 0.0
