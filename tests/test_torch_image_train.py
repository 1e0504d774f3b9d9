"""The port's image trainers and the two image CLI lines against the JAX
package on the CPU.

ImageRestorationTrainer and ImageNPPCTrainer at build_*_net's fixed widths
(UNet 32 -> 128, bottleneck 256) over an 8-item data module of 1 x 12 x 12
images, float32. The JAX trainers start from the same numpy-made params
through a monkeypatched jit_init (a JAX init of a whole model is avoided).
On the same (x_org, x_distorted):
  * the loss (MSE and MAE) and the NPPC objective within 1e-5 relative,
    every gradient within 1e-4 of its tensor's norm (the largest element's
    difference);
  * the parameters after two Adam steps within 1e-5, or within twice the
    learning rate where a gradient is rounding noise (Adam moves any
    parameter by about lr on its first step, whatever its gradient's size);
  * the benchmark's subset order and, for the deterministic inpainting_1,
    its value within 1e-5 relative;
  * round trips: from_checkpoint, and best params that survive later steps;
  * report.html: the restoration trainer's three image grids (original,
    distorted, restored) and the NPPC trainer's direction grid; the loss
    curve is SVG;
  * the CLI: configs/image_restoration.yaml and configs/image_nppc.yaml as
    shipped, with --steps 2 and a smaller synthetic-digit data module; the
    NPPC line reads the restoration run's latest; a named empty
    restoration_checkpoint raises; -R and --distributed raise.
"""
import json
import shutil
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.models import image_nppc as jax_nppc
from generative_audio_tpu.models import image_restoration as jax_rest
from generative_audio_tpu.train import image as jax_image
from generative_audio_torch.cli import train as train_cli
from generative_audio_torch.data import image_data
from generative_audio_torch.models import image_nppc, image_restoration
from generative_audio_torch.train import image
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
LR = 1e-4


class _Digits:
    """8 items of 1 x 12 x 12: synthetic digits, cropped, with a little
    uniform noise, so that no region is constant (a max pool over a
    constant window has ties, and torch and XLA route the gradient of a tie
    to different elements)."""
    shape = (1, 12, 12)
    mean = 0.5
    std = 0.2

    def __init__(self, n=8):
        arr = image_data.synthetic_digits(n, seed=4)[:, :, 8:20, 8:20]
        arr = 0.9 * arr + np.random.default_rng(5).uniform(0, 0.1, arr.shape)
        self.train_set = self.valid_set = self.test_set = list(
            arr.astype(np.float32))


def _batch(dm, n=4):
    return np.stack([np.asarray(dm.valid_set[i]) for i in range(n)])


def _noisy(x, seed):
    """x + 0.3 N(0, 1): a distorted batch without the clip's ties."""
    return x + 0.3 * torch.from_numpy(np.random.default_rng(seed)
                                      .standard_normal(x.shape, np.float32))


def _rest_pair(monkeypatch, distortion="denoising_1", loss_type="mse",
               seed=20):
    """(port trainer, JAX trainer, JAX params) with the same params."""
    cfg = image_restoration.ImageRestorationConfig(
        distortion_type=distortion, loss_type=loss_type, lr=LR)
    model = image_restoration.ImageRestorationModel(cfg, data_module=_Digits())
    params = convert.random_image_net_params(model.base_net, seed)
    model.base_net.load_state_dict(convert.convert_image_net(params,
                                                             model.base_net))
    trainer = image.ImageRestorationTrainer(cfg, model=model, device="cpu")
    monkeypatch.setattr(jax_image, "jit_init",
                        lambda init: lambda key: {"params": params["params"]})
    jcfg = jax_rest.ImageRestorationConfig(
        distortion_type=distortion, loss_type=loss_type, lr=LR)
    jtrainer = jax_image.ImageRestorationTrainer(
        jcfg, model=jax_rest.ImageRestorationModel(jcfg,
                                                   data_module=_Digits()))
    return trainer, jtrainer, params


def _nppc_pair(monkeypatch, distortion="denoising_1", n_dirs=3, seed=30):
    trainer, jtrainer, rparams = _rest_pair(monkeypatch, distortion)
    cfg = image_nppc.ImageNPPCConfig(n_dirs=n_dirs, lr=LR,
                                     second_moment_loss_grace=4)
    nppc = image.ImageNPPCTrainer(cfg, trainer.model, device="cpu")
    net = nppc.model.wrapper.net
    params = {"net": convert.random_image_net_params(net, seed)}
    net.load_state_dict(convert.convert_image_net(params["net"], net))
    monkeypatch.setattr(jax_image, "jit_init", lambda init: lambda key: params)
    jnppc = jax_image.ImageNPPCTrainer(
        jax_nppc.ImageNPPCConfig(n_dirs=n_dirs, lr=LR,
                                 second_moment_loss_grace=4),
        jtrainer.model, {"params": rparams["params"]})
    return nppc, jnppc, params


def _grads_close(named, net, jgrads, prefix):
    got = convert.to_jax_image_net(named, net, prefix)["params"]
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(got),
                     jax.tree_util.tree_leaves(jgrads)))
    assert len(pairs) == len(jax.tree_util.tree_leaves(jgrads))
    for (path, g), w in pairs:
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.linalg.norm(w), path


def _params_close(got, want, what):
    """Within 1e-5, or within 2 lr where Adam's first step moved a
    rounding-noise gradient the other way."""
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
        want)
    assert len(got) == len(want)
    far = 0
    for g, w in zip(got, want):
        diff = np.abs(g - np.asarray(w))
        assert diff.max() <= 2 * LR * 1.01, what
        far += int((diff > 1e-5).sum())
    total = sum(np.size(w) for w in want)
    assert far <= 1e-3 * total, (what, far, total)


@pytest.mark.parametrize("loss_type", ["mse", "mae"])
def test_restoration_loss_grad_and_adam_match_jax(monkeypatch, loss_type):
    trainer, jtrainer, params = _rest_pair(monkeypatch, loss_type=loss_type)
    wrapper = trainer.state.model
    x = torch.from_numpy(_batch(trainer.model.data_module))
    jparams = params["params"]
    jstate = jtrainer.state
    vg = jax.jit(jax.value_and_grad(jtrainer._loss_value))
    apply = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))
    for step in range(2):
        x_d = _noisy(x, step)
        loss = trainer.loss_value(x, x_d)
        loss.backward()
        jloss, jgrads = vg(jstate.params, jnp.asarray(x.numpy()),
                           jnp.asarray(x_d.numpy()))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
        if step == 0:
            _grads_close({k: p.grad for k, p in wrapper.named_parameters()},
                         trainer.model.base_net, jgrads, "net.")
        trainer.state.apply_gradients()
        jstate = apply(jstate, jgrads)
    assert trainer.state.step == int(jstate.step) == 2
    got = convert.to_jax_image_net(wrapper.state_dict(),
                                   trainer.model.base_net, "net.")["params"]
    _params_close(got, jstate.params, "restoration params after 2 steps")
    assert not np.array_equal(jax.tree_util.tree_leaves(got)[0],
                              jax.tree_util.tree_leaves(jparams)[0])


def test_nppc_objective_grad_and_adam_match_jax(monkeypatch):
    nppc, jnppc, params = _nppc_pair(monkeypatch)
    x = torch.from_numpy(_batch(nppc.restoration_model.data_module))
    net = nppc.model.wrapper.net
    jstate = jnppc.state
    vg = jax.jit(jax.value_and_grad(jnppc._objective, has_aux=True))
    apply = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))
    frozen = {k: v.clone() for k, v in
              nppc.restoration_model.wrapper.state_dict().items()}
    for step in range(2):
        x_d = _noisy(x, step)
        with torch.no_grad():
            x_r = nppc.restoration_model.restore(x_d)
        # step 3 of grace 4: the second moment's weight is 0.5 lambda
        obj, rec = nppc.objective(x, x_d, x_r, step + 3)
        obj.backward()
        (jobj, (jrec, _)), jgrads = vg(
            jstate.params, jnp.float32(step + 3), jnp.asarray(x.numpy()),
            jnp.asarray(x_d.numpy()), jnp.asarray(x_r.numpy()))
        assert abs(obj.item() - float(jobj)) <= 1e-5 * abs(float(jobj))
        np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jrec),
                                   rtol=1e-5, atol=1e-6)
        if step == 0:
            _grads_close({k: p.grad for k, p in
                          nppc.state.model.named_parameters()}, net,
                         jgrads["net"]["params"], "net.")
        nppc.state.apply_gradients()
        jstate = apply(jstate, jgrads)
    got = convert.to_jax_image_net(nppc.state.model.state_dict(), net,
                                   "net.")["params"]
    _params_close(got, jstate.params["net"]["params"],
                  "PC net params after 2 steps")
    assert all(torch.equal(v, frozen[k]) for k, v in
               nppc.restoration_model.wrapper.state_dict().items())
    assert all(p.grad is None for p in
               nppc.restoration_model.wrapper.parameters())


def test_restoration_x_restored_matches_jax_trainer(monkeypatch):
    """The NPPC trainer's frozen restoration on the same x_distorted, and
    its directions, against the JAX trainer's."""
    nppc, jnppc, _ = _nppc_pair(monkeypatch, distortion="inpainting_1")
    x = torch.from_numpy(_batch(nppc.restoration_model.data_module))
    x_d, x_r = nppc.process_batch(x, None)
    jx_d, jx_r = jax.jit(jnppc._process_batch)(None, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(x_d.numpy(), np.asarray(jx_d), atol=1e-6)
    np.testing.assert_allclose(x_r.numpy(), np.asarray(jx_r), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jx_r)).max())
    with torch.no_grad():
        w = nppc.get_dirs(x_d, x_r).numpy()
    jw = np.asarray(jax.jit(jnppc.get_dirs)(jnp.asarray(x_d.numpy()),
                                            jnp.asarray(x_r.numpy())))
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5 * np.abs(jw).max())


@pytest.mark.parametrize("kind", ["restoration", "nppc"])
def test_benchmark_matches_jax_subset_and_value(monkeypatch, kind):
    """The seed-42 subset in the JAX order, and on the deterministic
    inpainting_1 the same score."""
    pair = (_rest_pair if kind == "restoration" else _nppc_pair)(
        monkeypatch, distortion="inpainting_1")
    trainer, jtrainer = pair[0], pair[1]
    valid = _Digits().valid_set
    got = list(trainer._batches(valid, 3, 7))
    want = list(jtrainer._batches(valid, 3, 7))
    assert [b.shape for b in got] == [(3, 1, 12, 12)] * 2 + [(1, 1, 12, 12)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    score = trainer.benchmark(batch_size=3, max_samples=7)
    jscore = jtrainer.benchmark(batch_size=3, max_samples=7)
    assert abs(score - jscore) <= 1e-5 * abs(jscore)


def test_train_order_matches_jax(monkeypatch):
    """The loop's batches: default_rng(0)'s permutation, redrawn when a pass
    runs out (8 items at batch 3: two batches a pass)."""
    trainer, jtrainer, _ = _rest_pair(monkeypatch)
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(trainer, "train_step",
                        lambda b: seen["port"].append(b) or torch.tensor(0.))
    monkeypatch.setattr(jtrainer, "step",
                        lambda b: seen["jax"].append(b) or 0.0)
    trainer.train(n_steps=5, batch_size=3)
    jtrainer.train(n_steps=5, batch_size=3)
    assert len(seen["port"]) == len(seen["jax"]) == 5
    assert all(np.array_equal(a, b) for a, b in zip(seen["port"],
                                                    seen["jax"]))


def test_from_checkpoint_round_trip(tmp_path):
    cfg = image_restoration.ImageRestorationConfig(lr=LR)
    model = image_restoration.ImageRestorationModel(cfg,
                                                    data_module=_Digits())
    t1 = image.ImageRestorationTrainer(cfg, model=model, device="cpu",
                                       checkpoint_dir=tmp_path / "ck")
    t1.train(n_steps=2, batch_size=4, log=lambda *a: None)
    t2 = image.ImageRestorationTrainer.from_checkpoint(tmp_path / "ck",
                                                       device="cpu")
    assert t2.config == cfg
    sd1, sd2 = t1.state.model.state_dict(), t2.state.model.state_dict()
    assert sd1.keys() == sd2.keys()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    with pytest.raises(FileNotFoundError, match="config.json"):
        image.ImageRestorationTrainer.from_checkpoint(tmp_path / "none")


def test_best_params_survive_later_steps(tmp_path):
    cfg = image_restoration.ImageRestorationConfig(lr=1e-2)
    model = image_restoration.ImageRestorationModel(cfg,
                                                    data_module=_Digits())
    trainer = image.ImageRestorationTrainer(cfg, model=model, device="cpu",
                                            checkpoint_dir=tmp_path / "ck")
    x = _batch(model.data_module)
    trainer.step(x)
    assert trainer._maybe_update_best(0.0)       # 0.0 stays the best
    snapshot = {k: v.clone() for k, v in trainer.best_params.items()}
    trainer.step(x)
    trainer.step(x)
    assert not trainer._maybe_update_best(1.0)
    current = trainer.state.model.state_dict()
    assert all(torch.equal(v, snapshot[k])
               for k, v in trainer.best_params.items())
    assert any(not torch.equal(current[k], snapshot[k]) for k in snapshot)
    x_d = model.distort(torch.from_numpy(x), torch.Generator().manual_seed(1))
    with torch.no_grad():
        best = trainer.restore(x_d, use_best=True)
        now = trainer.restore(x_d, use_best=False)
        model.base_net.load_state_dict(
            {k[len("net."):]: v for k, v in snapshot.items()})
        want = model.restore(x_d)
    assert torch.equal(best, want) and not torch.equal(best, now)


def _pngs(html):
    return html.count("data:image/png;base64,")


def test_train_writes_latest_best_and_report_grids(tmp_path):
    cfg = image_restoration.ImageRestorationConfig(lr=LR)
    model = image_restoration.ImageRestorationModel(cfg,
                                                    data_module=_Digits())
    trainer = image.ImageRestorationTrainer(cfg, model=model, device="cpu",
                                            checkpoint_dir=tmp_path / "r")
    logs = []
    losses = trainer.train(n_steps=4, batch_size=4, benchmark_every=2,
                           log=logs.append)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len(logs) == 2 and "benchmark=" in logs[0]
    ck = tmp_path / "r"
    assert json.loads((ck / "latest_step.json").read_text())["step"] == 4
    best = torch.load(ck / "best.pt", weights_only=True)
    assert best["params"].keys() == trainer.state.model.state_dict().keys()
    assert json.loads((ck / "best_score.json").read_text())["score"] == \
        trainer.best_score
    html = (ck / "report.html").read_text()
    assert _pngs(html) == 3 and "<svg" in html and "error" not in html
    for name in ("original", "distorted", "restored"):
        assert f"<h2>{name}</h2>" in html
    nppc = image.ImageNPPCTrainer(
        image_nppc.ImageNPPCConfig(n_dirs=2, lr=LR), model, device="cpu",
        checkpoint_dir=tmp_path / "n")
    nppc.train(n_steps=2, batch_size=4, benchmark_every=1,
               log=lambda *a: None)
    html = (tmp_path / "n" / "report.html").read_text()
    assert _pngs(html) == 1 and "pc_directions (normalized)" in html
    assert (tmp_path / "n" / "best.pt").exists()


def test_report_grid_failure_is_logged_not_raised(tmp_path, monkeypatch):
    cfg = image_restoration.ImageRestorationConfig(lr=LR)
    trainer = image.ImageRestorationTrainer(
        cfg, model=image_restoration.ImageRestorationModel(
            cfg, data_module=_Digits()), device="cpu")

    def broken(rep):
        raise RuntimeError("no grid")

    monkeypatch.setattr(trainer, "_add_report_samples", broken)
    html = trainer.write_report(tmp_path / "r.html").read_text()
    assert "no grid" in html and _pngs(html) == 0


# -------------------------------------------------------------------- CLI --
@pytest.fixture
def small_digits(monkeypatch):
    """The CLI's data module shrunk to 80 synthetic digits (64 train, 16
    valid)."""
    real = image_data.make_data_module

    def small(dataset, img_size=None, data_folder=None, **kw):
        assert dataset == "mnist"
        return real(dataset, img_size, data_folder, n_valid=16,
                    n_synthetic=80)

    monkeypatch.setattr(image_data, "make_data_module", small)


def test_cli_image_lines_with_shipped_configs(tmp_path, monkeypatch,
                                              small_digits):
    monkeypatch.chdir(tmp_path)
    argv = ["--steps", "2", "--device", "cpu"]
    rest = train_cli.main(["-C", str(REPO / "configs/image_restoration.yaml")]
                          + argv)
    ck = tmp_path / "checkpoints" / "image_restoration"
    assert rest.state.step == 2 and len(rest.loss_history) == 2
    assert rest.model.config.distortion_type == "denoising_1"
    assert (ck / "latest.pt").exists() and _pngs(
        (ck / "report.html").read_text()) == 3
    nppc = train_cli.main(["-C", str(REPO / "configs/image_nppc.yaml")] + argv)
    latest = torch.load(ck / "latest.pt", weights_only=True)["params"]
    frozen = nppc.restoration_model.wrapper.state_dict()
    assert all(torch.equal(frozen[k], v) for k, v in latest.items())
    assert nppc.config.n_dirs == 5 and nppc.state.step == 2
    assert np.isfinite(nppc.loss_history).all()
    assert (tmp_path / "checkpoints" / "image_nppc" / "report.html").exists()


def test_cli_image_lines_refuse(tmp_path, monkeypatch, small_digits):
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "nppc.yaml"
    shutil.copy(REPO / "configs/image_nppc.yaml", cfg)
    (tmp_path / "checkpoints" / "image_restoration").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="holds no latest.pt"):
        train_cli.main(["-C", str(cfg), "--steps", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="do not resume"):
        train_cli.main(["-C", str(REPO / "configs/image_restoration.yaml"),
                        "-R", "--steps", "1", "--device", "cpu"])
    for var in ("MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "GAT_COORDINATOR", "GAT_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="lacks MASTER_PORT, RANK, "
                       "WORLD_SIZE, LOCAL_RANK"):
        train_cli.main(["-C", str(cfg), "--distributed", "--device", "cpu"])
    # the launcher's environment starts the job without a flag: both image
    # lines train as the one rank of a gloo world, under DDP
    from generative_audio_torch.parallel import distributed as D
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for var, value in (("GAT_COORDINATOR", f"127.0.0.1:{port}"),
                       ("GAT_NUM_PROCESSES", "1"), ("GAT_PROCESS_ID", "0"),
                       ("GAT_BACKEND", "gloo"), ("GAT_TIMEOUT", "60")):
        monkeypatch.setenv(var, value)
    try:
        rest = train_cli.main(["-C", str(REPO / "configs/image_restoration"
                                         ".yaml"), "--steps", "1",
                               "--device", "cpu"])
        assert D.is_initialized() and rest.mesh is not None
        assert type(rest.net).__name__ == "DistributedDataParallel"
        assert rest.state.step == 1
        nppc = train_cli.main(["-C", str(REPO / "configs/image_nppc.yaml"),
                               "--steps", "1", "--device", "cpu"])
        assert nppc.mesh is not None and nppc.state.step == 1
        assert np.isfinite(nppc.loss_history).all()
    finally:
        D.shutdown()


def test_image_trainer_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = image_restoration.ImageRestorationConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image.ImageRestorationTrainer(cfg, model=image_restoration.
                                      ImageRestorationModel(
                                          cfg, data_module=_Digits()))
