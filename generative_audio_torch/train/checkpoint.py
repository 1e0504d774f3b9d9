"""Checkpoints: latest + per-step-tagged + best, with the config beside them.

Port of generative_audio_tpu/train/checkpoint.py:33-211 on `torch.save` /
`torch.load` instead of orbax. A checkpoint is one file `<name>.pt` holding
a tree of dicts, lists, numbers and tensors (a model `state_dict`, an
optimizer `state_dict`, the step, the best score); the sidecars
(`config.json`, `latest_step.json`, `best_score.json`) are plain JSON, as in
the JAX package. Files are written to a temporary name and renamed, so a
reader never sees half a checkpoint. The JAX package's multi-host
coordinator gate waits for the multi-GPU slice (ROADMAP.md, queue A item 6).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CheckpointManager", "resume_latest"]


def _merge(target, src, prefix: str, missing: List[str]):
    """`src` laid into `target`'s dict structure: keys of `target` that `src`
    lacks keep the target's value (load_state_dict(strict=False) semantics)
    and are listed in `missing`; keys only `src` has are dropped."""
    if isinstance(target, dict) and isinstance(src, dict):
        out = {}
        for k, v in target.items():
            if k in src:
                out[k] = _merge(v, src[k], f"{prefix}{k}/", missing)
            else:
                missing.append(f"{prefix}{k}")
                out[k] = v
        return out
    return src


class CheckpointManager:
    """latest/best/step-tagged checkpoints under one directory."""

    def __init__(self, directory, config: Optional[Any] = None):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        if config is not None:
            self.save_config(config)

    def _write_text(self, name: str, text: str) -> None:
        tmp = self.directory / f".{name}.tmp"
        tmp.write_text(text)
        os.replace(tmp, self.directory / name)

    # ------------------------------------------------------------ config ---
    def save_config(self, config) -> None:
        if dataclasses.is_dataclass(config):
            config = dataclasses.asdict(config)
        self._write_text("config.json",
                         json.dumps(config, indent=2, default=str))

    def load_config(self) -> Optional[Dict]:
        path = self.directory / "config.json"
        return json.loads(path.read_text()) if path.exists() else None

    # ------------------------------------------------------------- save ----
    def path(self, name: str) -> Path:
        return self.directory / f"{name}.pt"

    def _save(self, name: str, tree) -> None:
        tmp = self.directory / f".{name}.pt.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(name))

    def save_latest(self, state_tree, step: int) -> None:
        self._save("latest", state_tree)
        self._write_text("latest_step.json", json.dumps({"step": int(step)}))

    def save_step(self, state_tree, step: int) -> None:
        self._save(f"step_{int(step):08d}", state_tree)

    def save_best(self, state_tree, score: float, step: int,
                  extra: Optional[Dict] = None) -> None:
        """`extra` records the selection criterion beside the score, so that
        a resume can tell a score selected under another criterion."""
        self._save("best", state_tree)
        meta = {"score": float(score), "step": int(step)}
        if extra:
            meta.update({k: (float(v) if isinstance(v, (int, float)) else v)
                         for k, v in extra.items()})
        self._write_text("best_score.json", json.dumps(meta))

    # ---------------------------------------------------------- restore ----
    def restore(self, name: str, target_tree: Optional[Dict] = None,
                partial: bool = False):
        """The tree saved as `name` (tensors on the CPU), or None when there
        is none. With `target_tree`, the result has the target's keys:
        partial=True keeps the target's value for a key the checkpoint lacks
        (and warns), partial=False raises for it."""
        path = self.path(name)
        if not path.exists():
            return None
        tree = torch.load(path, map_location="cpu", weights_only=True)
        if target_tree is None:
            return tree
        missing: List[str] = []
        merged = _merge(target_tree, tree, "", missing)
        if missing and not partial:
            raise KeyError(f"checkpoint {path} lacks {missing[:8]}")
        if missing:
            warnings.warn(
                f"partial restore from {path}: {len(missing)} target key(s) "
                f"absent from the checkpoint kept their initialized values: "
                f"{missing[:8]}" + ("..." if len(missing) > 8 else ""))
        return merged

    def latest_step(self) -> Optional[int]:
        path = self.directory / "latest_step.json"
        return json.loads(path.read_text())["step"] if path.exists() else None

    def best_meta(self) -> Optional[Dict]:
        """The whole best_score.json record (score, step, criterion)."""
        path = self.directory / "best_score.json"
        return json.loads(path.read_text()) if path.exists() else None

    def best_score(self) -> Optional[float]:
        meta = self.best_meta()
        return None if meta is None else meta["score"]


def resume_latest(ckpt: Optional[CheckpointManager], state,
                  extra: Optional[Dict] = None, partial: bool = True):
    """Load the 'latest' checkpoint into `state` (a train.state.TrainState):
    parameters, optimizer state and step, plus any `extra` entries (e.g.
    best_score, whose given values are the defaults for an older checkpoint
    without them). Returns (state, restored tree), or (None, None) when there
    is nothing to resume."""
    if not ckpt:
        return None, None
    # the optimizer's tree is taken whole (a fresh optimizer's is empty)
    target = {**state.state_dict(), "opt_state": None, **(extra or {})}
    restored = ckpt.restore("latest", target, partial=partial)
    if restored is None:
        return None, None
    state.load_state_dict(restored)
    return state, restored
