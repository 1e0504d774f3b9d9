"""Corpus and misc tools: wav lists, VAD-filtered corpus building, directory
resampling, metric-file analysis, noisy-speech synthesis, DNS-MOS client.

Port of generative_audio_tpu/cli/tools.py (reference:
FullSubNet_plus/speech_enhance/tools/ — gen_lst.py:1-19, collect_lst.py:1-99,
resample_dir.py (sox there, scipy polyphase in a thread pool here),
analyse.py:1-61, noisyspeech_synthesizer.py (rebuilt on data.mixing),
dns_mos.py:13-116). Two differences: draw_hist writes an SVG histogram
(the JAX tool draws a matplotlib PNG), and dns_mos_score POSTs through the
standard library's urllib where the JAX tool imports requests.

All tools are callable functions plus a
`python -m generative_audio_torch.cli.tools <subcommand>` dispatcher.
"""
from __future__ import annotations

import argparse
import html
import json
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from generative_audio_torch.data.audio_io import (
    load_audio, read_wav, write_wav, resample, to_mono)
from generative_audio_torch.data.mixing import snr_mix, build_noise_track
from generative_audio_torch.ops.waveform import is_clipped, activity_detector

_HIST_COLORS = ("#1f77b4", "#ff7f0e")

__all__ = [
    "gen_lst", "collect_lst", "resample_dir", "read_metric_txt",
    "write_metric_txt", "compare_metric_files", "draw_hist",
    "synthesize_noisy_speech", "dns_mos_score",
]


def _find_audio(root, exts=(".wav",)) -> List[Path]:
    root = Path(root)
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in exts)


def gen_lst(dataset_dir, output_lst) -> int:
    """Recursive wav listing -> one path per line (gen_lst.py:5-11)."""
    files = _find_audio(dataset_dir)
    output_lst = Path(output_lst)
    output_lst.parent.mkdir(parents=True, exist_ok=True)
    output_lst.write_text("".join(f"{p}\n" for p in files))
    return len(files)


def collect_lst(candidate_datasets: Sequence, dist_file, sr: int = 16000,
                wav_min_second: float = 3.0,
                activity_threshold: float = 0.6, total_hrs: float = 30.0,
                seed: int = 0, log=print) -> Dict[str, int]:
    """Filter candidate wavs by clipping / energy activity / min length and
    collect up to total_hrs (collect_lst.py:19-99)."""
    paths: List[Path] = []
    for d in candidate_datasets:
        paths += _find_audio(d)
    random.Random(seed).shuffle(paths)

    kept, clipped, low_activity, too_short = [], [], [], []
    accumulated = 0.0
    for p in paths:
        y = load_audio(p, sr=sr)
        duration = len(y) / sr
        if duration < wav_min_second:
            too_short.append(p)
            continue
        if is_clipped(y):
            clipped.append(p)
            continue
        if activity_detector(y, fs=sr) < activity_threshold:
            low_activity.append(p)
            continue
        kept.append(p)
        accumulated += duration
        if accumulated >= total_hrs * 3600:
            break

    dist_file = Path(dist_file)
    dist_file.parent.mkdir(parents=True, exist_ok=True)
    dist_file.write_text("".join(f"{p}\n" for p in kept))
    stats = {"original": len(paths), "selected": len(kept),
             "selected_hrs": accumulated / 3600, "clipped": len(clipped),
             "low_activity": len(low_activity), "too_short": len(too_short)}
    log(f"collect_lst: {stats}")
    return stats


def resample_dir(input_dir, output_dir, sr: int = 16000,
                 num_workers: int = 8) -> int:
    """Polyphase-resample every wav into output_dir, preserving relative
    paths (resample_dir.py used `sox` via os.system; scipy here)."""
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    files = _find_audio(input_dir)

    def work(p: Path):
        in_sr, data = read_wav(p)
        data = to_mono(data)
        if in_sr != sr:
            data = resample(data, in_sr, sr)
        out = output_dir / p.relative_to(input_dir)
        out.parent.mkdir(parents=True, exist_ok=True)
        write_wav(out, data, sr)

    with ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(work, files))
    return len(files)


# ---------------------------------------------------------------------------
# Metric-file analysis (analyse.py)
# ---------------------------------------------------------------------------
def read_metric_txt(filename) -> Dict[str, float]:
    """'<name> <value>' per line -> dict (analyse.py:3-11)."""
    out = {}
    for line in Path(filename).read_text().splitlines():
        if not line.strip():
            continue
        name, value = line.split()[:2]
        out[name.rstrip(":")] = float(value)
    return out


def write_metric_txt(filename, ranked: List[Tuple[str, float]]):
    Path(filename).write_text(
        "".join(f"{name}: {value}\n" for name, value in ranked))


def compare_metric_dicts(d1: Dict[str, float],
                         d2: Dict[str, float]) -> List[Tuple[str, float]]:
    """Per-file metric delta, ranked descending (analyse.py:25-33)."""
    diffs = [(k, d1[k] - d2[k]) for k in d1 if k in d2]
    return sorted(diffs, key=lambda kv: kv[1], reverse=True)


def compare_metric_files(file1, file2) -> List[Tuple[str, float]]:
    return compare_metric_dicts(read_metric_txt(file1),
                                read_metric_txt(file2))


def draw_hist(data, filename, data2=None, labels=("a", "b")):
    """Histogram SVG (analyse.py:36-55): ten bins over each data set's own
    range, as matplotlib's `hist` draws them; with `data2`, both data sets
    overlaid and a legend. Each bar carries its count (data-count) and bin
    edges (data-lo, data-hi)."""
    sets = [(np.asarray(data, np.float64), labels[0], "blue")]
    if data2 is not None:
        sets = [(sets[0][0], labels[0], _HIST_COLORS[0]),
                (np.asarray(data2, np.float64), labels[1], _HIST_COLORS[1])]
    hists = [(np.histogram(d, bins=10), label, color)
             for d, label, color in sets]
    x0 = min(edges[0] for (_, edges), _, _ in hists)
    x1 = max(edges[-1] for (_, edges), _, _ in hists)
    top = max(1, max(int(counts.max()) for (counts, _), _, _ in hists))
    w, h, left, bottom, pad = 640, 400, 60, 45, 15
    pw, ph = w - left - pad, h - pad - bottom

    def px(x):
        return left + (x - x0) / (x1 - x0) * pw

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
             f'height="{h}" font-family="sans-serif" font-size="11">',
             f'<rect x="{left}" y="{pad}" width="{pw}" height="{ph}" '
             'fill="white" stroke="#888"/>']
    for i, ((counts, edges), label, color) in enumerate(hists):
        for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
            bh = c / top * ph
            parts.append(
                f'<rect class="bar" data-set="{i}" data-count="{int(c)}" '
                f'data-lo="{float(lo)!r}" data-hi="{float(hi)!r}" '
                f'x="{px(lo):.2f}" '
                f'y="{pad + ph - bh:.2f}" width="{px(hi) - px(lo):.2f}" '
                f'height="{bh:.2f}" fill="{color}" fill-opacity="0.7" '
                'stroke="black"/>')
        if data2 is not None:
            ly = pad + 14 + 14 * i
            parts.append(f'<rect x="{left + pw - 110}" y="{ly - 9}" '
                         f'width="12" height="10" fill="{color}"/>'
                         f'<text x="{left + pw - 94}" y="{ly}">'
                         f'{html.escape(str(label))}</text>')
    parts += [f'<text x="{left - 4}" y="{pad + 4}" text-anchor="end">'
              f'{top}</text>',
              f'<text x="{left - 4}" y="{pad + ph}" text-anchor="end">0'
              '</text>',
              f'<text x="{left}" y="{pad + ph + 14}" text-anchor="middle">'
              f'{x0:.4g}</text>',
              f'<text x="{left + pw}" y="{pad + ph + 14}" '
              f'text-anchor="middle">{x1:.4g}</text>',
              f'<text x="{left + pw / 2}" y="{h - 8}" text-anchor="middle">'
              'Interval</text>',
              f'<text x="14" y="{pad + ph / 2}" text-anchor="middle" '
              f'transform="rotate(-90 14 {pad + ph / 2})">Frequency</text>',
              "</svg>"]
    Path(filename).write_text("".join(parts))


# ---------------------------------------------------------------------------
# Noisy speech synthesizer (DNS-style)
# ---------------------------------------------------------------------------
def synthesize_noisy_speech(clean_dir, noise_dir, output_dir,
                            sr: int = 16000, snr_lower: float = 0.0,
                            snr_upper: float = 40.0,
                            total_snrlevels: int = 5,
                            total_hours: float = 0.01,
                            audio_length: float = 10.0,
                            silence_length: float = 0.2,
                            seed: int = 0, log=print) -> int:
    """Fixed-length (clean, noise, noisy) triples over an SNR grid
    (noisyspeech_synthesizer.py:11-123; its audiolib import is missing from
    the reference checkout — behavior rebuilt on data.mixing.snr_mix)."""
    rng = np.random.default_rng(seed)
    clean_files = _find_audio(clean_dir, exts=(".wav", ".flac"))
    noise_files = _find_audio(noise_dir, exts=(".wav", ".flac"))
    if not clean_files or not noise_files:
        raise FileNotFoundError("clean and noise dirs must contain audio")

    out = Path(output_dir)
    dirs = {k: out / f"{k}_training" for k in
            ("NoisySpeech", "CleanSpeech", "Noise")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)

    snrs = np.linspace(snr_lower, snr_upper, total_snrlevels)
    target_len = int(audio_length * sr)
    total_samples = int(total_hours * 3600 * sr)
    silence = int(silence_length * sr)

    written, generated = 0, 0
    while written < total_samples:
        clean = np.concatenate([
            load_audio(clean_files[int(rng.integers(len(clean_files)))], sr)
            for _ in range(3)])
        while len(clean) < target_len:
            clean = np.concatenate([
                clean, np.zeros(silence, np.float32),
                load_audio(clean_files[int(rng.integers(len(clean_files)))],
                           sr)])
        clean = clean[:target_len]

        def sample_noise(g=rng):
            return load_audio(
                noise_files[int(g.integers(len(noise_files)))], sr)
        noise = build_noise_track(target_len, sample_noise, silence, rng)

        snr = float(snrs[generated % total_snrlevels])
        noisy, clean_out = snr_mix(clean, noise, snr, target_dB_FS=-25,
                                   target_dB_FS_floating_value=1, rng=rng)
        stem = f"noisy{generated}_SNRdb_{snr:.1f}"
        write_wav(dirs["NoisySpeech"] / f"{stem}.wav", noisy, sr)
        write_wav(dirs["CleanSpeech"] / f"clean{generated}.wav", clean_out, sr)
        write_wav(dirs["Noise"] / f"noise{generated}.wav",
                  noisy - clean_out, sr)
        written += target_len
        generated += 1
    log(f"synthesize_noisy_speech: wrote {generated} triples "
        f"({written / sr / 3600:.4f} hrs)")
    return generated


# ---------------------------------------------------------------------------
# DNS-MOS web client
# ---------------------------------------------------------------------------
SCORING_URI_DNSMOS = "https://dnsmos.azurewebsites.net/score"
SCORING_URI_DNSMOS_P835 = "https://dnsmos.azurewebsites.net/v1/dnsmosp835/score"


def _post_json(uri: str, headers: Dict[str, str], payload: str) -> Dict:
    """POST the JSON text `payload` with `headers` to `uri` and return the
    reply's JSON: what the JAX client's requests.post(uri, data=payload,
    headers=headers).json() returns, through urllib.request (an HTTP error
    status raises urllib.error.HTTPError)."""
    import urllib.request
    request = urllib.request.Request(uri, data=payload.encode("utf-8"),
                                     headers=headers, method="POST")
    with urllib.request.urlopen(request) as reply:
        return json.loads(reply.read().decode("utf-8"))


def dns_mos_score(testset_dir, score_file, method: str = "p808",
                  auth_key: Optional[str] = None, post_fn=None,
                  log=print) -> List[Dict]:
    """POST each wav to the DNSMOS service, with file_mos.txt caching
    (dns_mos.py:25-116). `post_fn(uri, headers, payload) -> dict` is
    injectable for offline testing; by default `_post_json` (the standard
    library's urllib, needing network egress)."""
    if post_fn is None:
        post_fn = _post_json

    uri = SCORING_URI_DNSMOS_P835 if method == "p835" else SCORING_URI_DNSMOS
    headers = {"Content-Type": "application/json"}
    if auth_key:
        headers["Authorization"] = f"Basic {auth_key}"

    score_file = Path(score_file)
    score_file.parent.mkdir(parents=True, exist_ok=True)
    cache_path = score_file.parent / "file_mos.txt"
    cached = set()
    if cache_path.exists():
        cached = {line.split(".wav")[0]
                  for line in cache_path.read_text().splitlines()}

    rows = []
    for wav in _find_audio(testset_dir):
        utt = wav.stem
        if utt in cached:
            continue
        sr, audio = read_wav(wav)
        audio = to_mono(audio)
        if sr != 16000:
            audio = resample(audio, sr, 16000)
        payload = json.dumps({"data": audio.tolist(),
                              "filename": wav.name})
        result = dict(post_fn(uri, headers, payload))
        result["filename"] = wav.name
        rows.append(result)
        with open(cache_path, "a") as f:
            f.write(f"{wav.name} {json.dumps(result)}\n")
    if rows:
        try:
            import pandas as pd
            pd.DataFrame(rows).to_csv(score_file, index=False)
        except ImportError:
            score_file.write_text(json.dumps(rows, indent=2))
    log(f"dns_mos: scored {len(rows)} new files")
    return rows


# ---------------------------------------------------------------------------
# CLI dispatcher
# ---------------------------------------------------------------------------
def main(argv=None):
    parser = argparse.ArgumentParser(prog="generative_audio_torch.cli.tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gen_lst")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output_lst", required=True)

    p = sub.add_parser("collect_lst")
    p.add_argument("--candidate_datasets", required=True,
                   type=lambda s: s.split(","))
    p.add_argument("--dist_file", required=True)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--wav_min_second", type=float, default=3.0)
    p.add_argument("--activity_threshold", type=float, default=0.6)
    p.add_argument("--total_hrs", type=float, default=30.0)

    p = sub.add_parser("resample_dir")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--sr", type=int, default=16000)

    p = sub.add_parser("synthesize")
    p.add_argument("--clean_dir", required=True)
    p.add_argument("--noise_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--total_hours", type=float, default=0.01)
    p.add_argument("--snr_lower", type=float, default=0.0)
    p.add_argument("--snr_upper", type=float, default=40.0)

    p = sub.add_parser("dns_mos")
    p.add_argument("--testset_dir", required=True)
    p.add_argument("--score_file", required=True)
    p.add_argument("--method", default="p808", choices=["p808", "p835"])

    # per-file metric delta between two runs, ranked + optional histogram
    # (the analyse.py workflow, :58-62)
    p = sub.add_parser("analyse")
    p.add_argument("--file1", required=True, help="metric txt of run A")
    p.add_argument("--file2", required=True, help="metric txt of run B")
    p.add_argument("--output", required=True, help="ranked delta txt")
    p.add_argument("--hist", default="", help="optional histogram SVG path")

    args = parser.parse_args(argv)
    if args.cmd == "gen_lst":
        n = gen_lst(args.dataset_dir, args.output_lst)
        print(f"wrote {n} paths")
    elif args.cmd == "collect_lst":
        collect_lst(args.candidate_datasets, args.dist_file, args.sr,
                    args.wav_min_second, args.activity_threshold,
                    args.total_hrs)
    elif args.cmd == "resample_dir":
        n = resample_dir(args.input_dir, args.output_dir, args.sr)
        print(f"resampled {n} files")
    elif args.cmd == "synthesize":
        synthesize_noisy_speech(args.clean_dir, args.noise_dir,
                                args.output_dir,
                                total_hours=args.total_hours,
                                snr_lower=args.snr_lower,
                                snr_upper=args.snr_upper)
    elif args.cmd == "dns_mos":
        dns_mos_score(args.testset_dir, args.score_file, args.method)
    elif args.cmd == "analyse":
        d1, d2 = read_metric_txt(args.file1), read_metric_txt(args.file2)
        ranked = compare_metric_dicts(d1, d2)
        write_metric_txt(args.output, ranked)
        if args.hist:
            draw_hist(list(d1.values()), args.hist,
                      data2=list(d2.values()),
                      labels=(Path(args.file1).stem, Path(args.file2).stem))
        dropped = len(d1) + len(d2) - 2 * len(ranked)
        print(f"wrote {len(ranked)} deltas"
              + (f" ({dropped} entries present in only one file)"
                 if dropped else ""))


if __name__ == "__main__":
    main()
