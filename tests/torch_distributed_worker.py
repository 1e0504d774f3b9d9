"""The ranks' side of tests/test_torch_distributed.py: run under
generative_audio_torch.cli.launch with the GAT_* environment, on the CPU
over gloo. Every rank writes its own result file, so that the test can hold
the ranks against each other as well as against one process.

    python tests/torch_distributed_worker.py OUT PART [:: PART ...]

runs each PART in turn in one job, every rank writing into OUT:
    lines LINE [LINE ...]
        each trainer line's two steps over a parallel.make_mesh(), on the
        numpy-made parameters and the global batches of LINES (the test
        calls the same functions with mesh=None for the single process):
        OUT/rank{r}.pt holds {line: {"losses", "state"}}.
    cli ARG [ARG ...] [-- ARG ...]
        cli.train.main on each `--`-separated argument list in turn, with
        every file the process opens for writing recorded
        (OUT/writes_rank{r}.json), each run's step, best_val and the
        checkpoint's latest_step.json (OUT/runs_rank{r}.json) and each
        run's trained state (OUT/state_rank{r}_{i}.pt).
"""
import builtins
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 2


def numpy_state(module, seed):
    """Load numpy-made parameters into every trainable tensor of `module`:
    U(-1, 1) / sqrt(fan-in) for weights, 1 + U(-0.1, 0.1) for 1-D weights
    (norm gains), U(-0.1, 0.1) for biases."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            u = rng.uniform(-1.0, 1.0, tuple(p.shape)).astype(np.float32)
            if p.ndim >= 2:
                u /= np.sqrt(np.prod(p.shape[1:]))
            elif name.endswith("weight"):
                u = 1.0 + 0.1 * u
            else:
                u *= 0.1
            p.copy_(torch.from_numpy(u))
    return module


# the JAX tests' shapes (tests/test_parallel.py:172-291,
# tests/distributed_worker.py:40-50)
ENHANCE_MODEL = dict(num_freqs=32, sb_num_neighbors=3, fb_model_hidden_size=32,
                     sb_model_hidden_size=16, num_groups_in_drop_band=2)
STFT = dict(n_fft=62, hop_length=32, win_length=62)


def enhance_config(groups=2):
    from generative_audio_torch.models import FullSubNetPlusConfig
    from generative_audio_torch.train import EnhanceTrainConfig
    return EnhanceTrainConfig(
        model=FullSubNetPlusConfig(**{**ENHANCE_MODEL,
                                      "num_groups_in_drop_band": groups}),
        compute_dtype="float32", **STFT)


def enhance_batches():
    """tests/distributed_worker.py's SyntheticPairs(8) in two global
    batches of 4."""
    pairs = []
    for i in range(8):
        rng = np.random.default_rng(1000 + i)
        clean = rng.standard_normal(4096).astype(np.float32) * 0.05
        pairs.append((clean + 0.02 * rng.standard_normal(4096)
                      .astype(np.float32), clean))
    return [tuple(np.stack([p[j] for p in pairs[k:k + 4]]) for j in (0, 1))
            for k in (0, 4)]


def _enhance(mesh, groups=2, accum=1):
    from generative_audio_torch.train import EnhanceTrainer
    from generative_audio_torch.train.enhance import make_enhance_train_step
    trainer = EnhanceTrainer(enhance_config(groups), device="cpu", mesh=mesh)
    numpy_state(trainer.state.model, 10)
    if mesh is not None:       # DDP took the parameters at construction
        from generative_audio_torch.parallel import replicate_state
        replicate_state(trainer.state.model, mesh)
    trainer._step_fn = make_enhance_train_step(trainer.config, accum,
                                               net=trainer.net)
    losses = [trainer.train_epoch([b]) for b in enhance_batches()]
    return losses, trainer.state.model


def _nppc_denoising(mesh):
    from generative_audio_torch.models import (
        FullSubNetPlusConfig, MultiDirectionConfig)
    from generative_audio_torch.models.nppc_model import (
        DenoisingNPPCConfig, StftConfig)
    from generative_audio_torch.train import (
        NPPCDenoisingTrainConfig, NPPCDenoisingTrainer)
    md = MultiDirectionConfig(num_freqs=32, sb_num_neighbors=2,
                              fb_model_hidden_size=16, sb_model_hidden_size=8,
                              num_groups_in_drop_band=2, n_directions=2)
    rest = FullSubNetPlusConfig(num_freqs=32, sb_num_neighbors=2,
                                fb_model_hidden_size=16,
                                sb_model_hidden_size=8,
                                num_groups_in_drop_band=1)
    cfg = NPPCDenoisingTrainConfig(
        model=DenoisingNPPCConfig(
            restoration=rest, pc_wrapper=md,
            stft=StftConfig(nfft=62, hop_length=32, win_length=62)),
        second_moment_loss_grace=4)
    trainer = NPPCDenoisingTrainer(cfg, device="cpu",
                                   compute_dtype=torch.float32, mesh=mesh)
    model = trainer.state.model
    numpy_state(model.pretrained_restoration_model, 11)
    numpy_state(model.audio_pc_wrapper, 12)
    rng = np.random.default_rng(2)
    clean = rng.standard_normal((8, 2048)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((8, 2048)).astype(np.float32)
    losses = [trainer.train_step(noisy, clean)[0] for _ in range(STEPS)]
    return _global(losses, mesh), model.audio_pc_wrapper


def _inpaint_batch(seed, gap):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((8, 2, 32, 64)).astype(np.float32)
    mask = np.ones((8, 64), np.float32)
    mask[:, gap] = 0
    return (clean * mask[:, None, None, :], mask, clean)


def _restoration(mesh):
    from generative_audio_torch.models.nppc_model import UNetModelConfig
    from generative_audio_torch.train import (
        RestorationTrainConfig, RestorationTrainer)
    cfg = RestorationTrainConfig(
        model=UNetModelConfig(in_channels=1, out_channels=1, dropout=0.2),
        num_freqs=32, num_frames=64)
    trainer = RestorationTrainer(cfg, device="cpu", mesh=mesh)
    numpy_state(trainer.state.model, 13)
    batch = _inpaint_batch(0, slice(20, 30))
    losses = [trainer.train_step(batch) for _ in range(STEPS)]
    return _global(losses, mesh), trainer.state.model


def _nppc_inpainting(mesh, variant="base_step"):
    from generative_audio_torch.models.nppc_model import (
        InpaintingNPPCConfig, UNetModelConfig)
    from generative_audio_torch.models.pc_wrapper import (
        AudioInpaintingPCWrapperConfig)
    from generative_audio_torch.train import (
        NPPCInpaintingTrainConfig, NPPCInpaintingTrainer)
    mc = variant == "mc_pca_aligned"
    cfg = NPPCInpaintingTrainConfig(
        model=InpaintingNPPCConfig(
            restoration=UNetModelConfig(1, 1, 0.2 if mc else 0.0),
            pc_wrapper=AudioInpaintingPCWrapperConfig(
                in_channels=2, out_channels=3, n_dirs=3)),
        num_freqs=32, num_frames=64, second_moment_loss_grace=4,
        objective_variant=variant, n_mc_samples=4, mc_chunk_size=2)
    trainer = NPPCInpaintingTrainer(cfg, device="cpu", mesh=mesh)
    model = trainer.state.model
    numpy_state(model.pretrained_restoration_model, 14)
    numpy_state(model.pc_wrapper, 15)
    batch = _inpaint_batch(1, slice(10, 22))
    losses = [trainer.train_step(batch)[0] for _ in range(STEPS)]
    return _global(losses, mesh), model.pc_wrapper


class Digits:
    """8 synthetic digits of 1 x 12 x 12 (tests/test_torch_image_train.py's
    _Digits)."""
    shape = (1, 12, 12)
    mean = 0.5
    std = 0.2

    def __init__(self, n=8):
        from generative_audio_torch.data import image_data
        arr = image_data.synthetic_digits(n, seed=4)[:, :, 8:20, 8:20]
        arr = 0.9 * arr + np.random.default_rng(5).uniform(0, 0.1, arr.shape)
        self.train_set = self.valid_set = self.test_set = list(
            arr.astype(np.float32))


def _image_restoration_trainer(mesh):
    from generative_audio_torch.models import image_restoration
    from generative_audio_torch.train import ImageRestorationTrainer
    from generative_audio_torch.utils import convert
    cfg = image_restoration.ImageRestorationConfig(
        distortion_type="denoising_1", lr=1e-4)
    model = image_restoration.ImageRestorationModel(cfg, data_module=Digits())
    model.base_net.load_state_dict(convert.convert_image_net(
        convert.random_image_net_params(model.base_net, 20), model.base_net))
    return ImageRestorationTrainer(cfg, model=model, device="cpu", mesh=mesh)


def _image_restoration(mesh):
    trainer = _image_restoration_trainer(mesh)
    x = np.stack(Digits().train_set)
    losses = [trainer.train_step(x) for _ in range(STEPS)]
    return _global(losses, mesh), trainer.state.model


def _image_nppc(mesh):
    from generative_audio_torch.models import image_nppc
    from generative_audio_torch.train import ImageNPPCTrainer
    rest = _image_restoration_trainer(None)
    trainer = ImageNPPCTrainer(
        image_nppc.ImageNPPCConfig(n_dirs=2, lr=1e-4,
                                   second_moment_loss_grace=4),
        rest.model, device="cpu", mesh=mesh)
    x = np.stack(Digits().train_set)
    losses = [trainer.train_step(x) for _ in range(STEPS)]
    return _global(losses, mesh), trainer.state.model


def _global(losses, mesh):
    from generative_audio_torch.parallel.mesh import mean_over_ranks
    return mean_over_ranks(torch.stack(losses), mesh).tolist()


LINES = {
    "enhance": _enhance,
    "enhance_accum": lambda mesh: _enhance(mesh, groups=1, accum=2),
    "nppc_denoising": _nppc_denoising,
    "restoration": _restoration,
    "nppc_inpainting": _nppc_inpainting,
    "nppc_inpainting_mc": lambda mesh: _nppc_inpainting(mesh,
                                                        "mc_pca_aligned"),
    "image_restoration": _image_restoration,
    "image_nppc": _image_nppc,
}


def run_line(line, mesh):
    """{"losses": the global batch's losses, "state": the trained module's
    parameters and buffers} after two steps."""
    losses, module = LINES[line](mesh)
    return {"losses": [float(x) for x in losses],
            "state": {k: v.detach().clone()
                      for k, v in module.state_dict().items()}}


class _Writes:
    """Every path this process opens for writing, or torch.save writes."""

    def __init__(self):
        self.paths = []
        self._open, self._io_open, self._save = (builtins.open, io.open,
                                                 torch.save)

    def _record(self, file):
        if isinstance(file, (str, os.PathLike)):
            self.paths.append(os.path.abspath(os.fspath(file)))

    def _wrap(self, real):
        def opener(file, mode="r", *args, **kwargs):
            if any(c in mode for c in "wax+"):
                self._record(file)
            return real(file, mode, *args, **kwargs)
        return opener

    def __enter__(self):
        builtins.open = self._wrap(self._open)
        io.open = self._wrap(self._io_open)

        def save(obj, f, *args, **kwargs):
            self._record(f)
            return self._save(obj, f, *args, **kwargs)
        torch.save = save
        return self

    def __exit__(self, *exc):
        builtins.open, io.open, torch.save = (self._open, self._io_open,
                                              self._save)


def _lines(out, rank, lines):
    from generative_audio_torch.parallel import make_mesh
    mesh = make_mesh()
    torch.save({line: run_line(line, mesh) for line in lines},
               out / f"rank{rank}.pt")


def _cli(out, rank, argv):
    from generative_audio_torch.cli import train as train_cli
    runs, args = [], []
    for a in argv + ["--"]:
        if a == "--":
            runs.append(args)
            args = []
        else:
            args.append(a)
    states, record = [], []
    with _Writes() as writes:
        for args in runs:
            trainer = train_cli.main(args)
            states.append({k: v.detach().clone() for k, v in
                           trainer.state.model.state_dict().items()})
            record.append({"step": trainer.state.step,
                           "best_val": getattr(trainer, "best_val", None),
                           "latest_step": trainer.ckpt.latest_step()})
    (out / f"writes_rank{rank}.json").write_text(json.dumps(writes.paths))
    (out / f"runs_rank{rank}.json").write_text(json.dumps(record))
    for i, state in enumerate(states):
        torch.save(state, out / f"state_rank{rank}_{i}.pt")


def main(argv):
    from generative_audio_torch.parallel import distributed as D
    out = Path(argv[0])
    assert D.initialize(), "run under generative_audio_torch.cli.launch"
    parts, part = [], []
    for a in argv[1:] + ["::"]:
        if a == "::":
            parts.append(part)
            part = []
        else:
            part.append(a)
    for mode, *args in parts:
        {"lines": _lines, "cli": _cli}[mode](out, D.process_index(), args)
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
