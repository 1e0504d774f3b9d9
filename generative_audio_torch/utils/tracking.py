"""Local experiment tracking + artifact registry (wandb-equivalent).

Reference usage being replaced:
  - wandb.init / wandb.log scalar streams (inpainting trainers,
    restoration_trainer.py:260-327, nppc_trainer.py:604-628)
  - wandb artifact store as the checkpoint registry: trainers push
    checkpoints as named artifacts; consumers fetch by "name:version"
    (inpainting/nppc/nppc_model.py:52-98 _load_from_wandb).

The port's own copy of generative_audio_tpu/utils/tracking.py. It
implements the same contract on the local filesystem (no network needed):
runs live under <root>/runs/<run_id>/ with config.json + scalars.jsonl +
summary.json; artifacts under <root>/artifacts/<name>/v<k>/ with files +
metadata, "name:latest" resolving to the highest version.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

__all__ = ["ExperimentTracker", "ArtifactRegistry"]


class ArtifactRegistry:
    """Versioned named artifact store (wandb-artifact contract)."""

    def __init__(self, root):
        self.root = Path(root)
        (self.root / "artifacts").mkdir(parents=True, exist_ok=True)

    def _versions(self, name: str):
        base = self.root / "artifacts" / name
        if not base.is_dir():
            return []
        return sorted(int(p.name[1:]) for p in base.iterdir()
                      if p.name.startswith("v") and p.name[1:].isdigit())

    def log_artifact(self, name: str, files, metadata: Optional[Dict] = None,
                     artifact_type: str = "model") -> str:
        """Store files as the next version of `name`; returns 'name:vK'."""
        if isinstance(files, (str, Path)):
            files = [files]
        versions = self._versions(name)
        version = (versions[-1] + 1) if versions else 0
        dest = self.root / "artifacts" / name / f"v{version}"
        dest.mkdir(parents=True)
        for f in files:
            f = Path(f)
            if f.is_dir():
                shutil.copytree(f, dest / f.name)
            else:
                shutil.copy2(f, dest / f.name)
        meta = dict(metadata or {}, type=artifact_type,
                    created=time.strftime("%Y-%m-%dT%H:%M:%S"))
        (dest / "artifact.json").write_text(json.dumps(meta, indent=2,
                                                       default=str))
        return f"{name}:v{version}"

    def get_artifact(self, ref: str) -> Path:
        """Resolve 'name', 'name:latest' or 'name:vK' to its directory."""
        name, _, version = ref.partition(":")
        versions = self._versions(name)
        if not versions:
            raise FileNotFoundError(f"no artifact named {name!r} under "
                                    f"{self.root / 'artifacts'}")
        if version in ("", "latest"):
            k = versions[-1]
        else:
            k = int(version.lstrip("v"))
            if k not in versions:
                raise FileNotFoundError(f"artifact {name}:v{k} not found")
        return self.root / "artifacts" / name / f"v{k}"

    def metadata(self, ref: str) -> Dict:
        return json.loads((self.get_artifact(ref) / "artifact.json")
                          .read_text())


class ExperimentTracker:
    """Append-only scalar stream + config/summary snapshot per run."""

    def __init__(self, root, run_name: Optional[str] = None,
                 config: Optional[Any] = None, tensorboard: bool = False):
        self.root = Path(root)
        run_id = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        # de-dupe run dirs
        base, k = run_id, 1
        while (self.root / "runs" / run_id).exists():
            run_id = f"{base}_{k}"
            k += 1
        self.run_id = run_id
        self.run_dir = self.root / "runs" / run_id
        self.run_dir.mkdir(parents=True)
        self._scalars = open(self.run_dir / "scalars.jsonl", "a")
        self._summary: Dict[str, Any] = {}
        self.artifacts = ArtifactRegistry(self.root)
        self._tb = None
        if tensorboard:
            # the reference's writer (base_trainer.py:95-100); it needs the
            # tensorboard package
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.run_dir / "tb"))
        if config is not None:
            import dataclasses
            if dataclasses.is_dataclass(config):
                config = dataclasses.asdict(config)
            (self.run_dir / "config.json").write_text(
                json.dumps(config, indent=2, default=str))

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        row = {"_step": step, "_time": time.time()}
        row.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._scalars.write(json.dumps(row, default=str) + "\n")
        self._scalars.flush()
        self._summary.update({k: row[k] for k in metrics})
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(row[k], float):
                    self._tb.add_scalar(k, row[k], global_step=step)

    def log_artifact(self, name: str, files, metadata=None,
                     artifact_type: str = "model") -> str:
        meta = dict(metadata or {}, run_id=self.run_id)
        return self.artifacts.log_artifact(name, files, meta, artifact_type)

    def finish(self):
        (self.run_dir / "summary.json").write_text(
            json.dumps(self._summary, indent=2, default=str))
        self._scalars.close()
        if self._tb is not None:
            self._tb.close()

    def read_scalars(self):
        path = self.run_dir / "scalars.jsonl"
        return [json.loads(line) for line in path.read_text().splitlines()]
