"""Metric computation CLI over reference and estimated wav directories.

    python -m generative_audio_torch.cli.calculate_metrics \
        -R ref_dir -E est_dir -M SI_SDR,STOI [--sr 16000] [-O results.json]

Port of generative_audio_tpu/cli/calculate_metrics.py (reference:
tools/calculate_metrics.py: joblib fan-out, per-file rows, DNS filename
realignment). Pairs files by name (`plain`) or by the trailing fileid
(`dns_1`, `dns_2`), scores each pair in a pool of `--jobs` processes, prints
the means as JSON and writes {"mean", "per_file"} to `-O`. Host numpy only:
no device is used.
"""
from __future__ import annotations

import argparse
import json
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

__all__ = ["main"]


def _align_pairs(ref_dir: Path, est_dir: Path, dataset_style: str):
    """Pair files by name; the DNS styles realign by the trailing fileid
    (tools/calculate_metrics.py:60-112)."""
    est_files = sorted(est_dir.rglob("*.wav"))
    pairs = []
    for est in est_files:
        if dataset_style in ("dns_1", "dns_2"):
            fileid = est.stem.split("_")[-1]
            cands = list(ref_dir.glob(f"*_{fileid}.wav"))
            ref = cands[0] if cands else ref_dir / est.name
        else:
            ref = ref_dir / est.name
        if ref.exists():
            pairs.append((ref, est))
    return pairs


def _score_one(task):
    ref_path, est_path, metric_names, sr = task
    from generative_audio_torch.data.audio_io import load_audio
    from generative_audio_torch.eval import metrics as M
    ref = load_audio(ref_path, sr)
    est = load_audio(est_path, sr)
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    row = {"file": Path(est_path).name}
    for name in metric_names:
        try:
            row[name] = float(M.REGISTERED_METRICS[name](ref, est, sr))
        except M.MetricUnavailable:
            row[name] = None
        except Exception as e:  # noqa: BLE001
            row[name] = None
            row.setdefault("errors", []).append(f"{name}: {e}")
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="generative_audio_torch metrics over two wav directories")
    parser.add_argument("-R", "--reference_dir", required=True)
    parser.add_argument("-E", "--estimated_dir", required=True)
    parser.add_argument("-M", "--metrics", default="SI_SDR,STOI")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--dataset_style", default="plain",
                        choices=["plain", "dns_1", "dns_2"])
    parser.add_argument("-O", "--output", default=None)
    parser.add_argument("--jobs", type=int, default=8)
    args = parser.parse_args(argv)

    metric_names = [m.strip() for m in args.metrics.split(",")]
    pairs = _align_pairs(Path(args.reference_dir), Path(args.estimated_dir),
                         args.dataset_style)
    if not pairs:
        raise SystemExit("No (reference, estimated) pairs found")

    tasks = [(str(r), str(e), metric_names, args.sr) for r, e in pairs]
    # spawn, not fork: a parent that has touched CUDA must not fork
    import multiprocessing as mp
    with ProcessPoolExecutor(args.jobs,
                             mp_context=mp.get_context("spawn")) as pool:
        rows = list(pool.map(_score_one, tasks))

    means = {}
    for name in metric_names:
        vals = [r[name] for r in rows if r.get(name) is not None]
        means[name] = float(np.mean(vals)) if vals else None
    result = {"mean": means, "per_file": rows}
    print(json.dumps(means, indent=2))
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
