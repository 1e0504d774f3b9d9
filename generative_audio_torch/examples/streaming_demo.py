"""Real-time streaming enhancement on the port, no external data.

    python3 -m generative_audio_torch.examples.streaming_demo [--device cpu]

Simulates a live audio source delivering pieces of random sizes of a noisy
clip to `eval.streaming.StreamingEnhancer`, collects the finalized output
piece by piece, and checks that it is bit-identical to the offline
`overlapped_chunk` mode on the whole clip. The model is a FullSubNet+ at
its default float32 compute dtype (257 bins, full-band LSTM 64, sub-band
48), with random weights from a seed: on the card its recurrent layers run
the scan kernels over bf16 gates with float32 output, the rest in float32.

Port of examples/streaming_demo.py. Runs on the card unless given
--device cpu.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from generative_audio_torch.eval import Inferencer, InferencerConfig
    from generative_audio_torch.eval.streaming import StreamingEnhancer
    from generative_audio_torch.models import (
        FullSubNetPlus, FullSubNetPlusConfig)

    # a small random-weight model keeps the demo fast; load converted
    # reference weights (utils/convert.py) for real enhancement
    cfg = FullSubNetPlusConfig(num_freqs=257, fb_model_hidden_size=64,
                               sb_model_hidden_size=48)
    torch.manual_seed(0)
    model = FullSubNetPlus(cfg, compute_dtype=torch.float32,
                           device=args.device)
    inf = Inferencer(model, InferencerConfig(chunk_length_seconds=1,
                                             chunk_model="spectral"),
                     device=args.device)

    rng = np.random.default_rng(0)
    sr = 16000
    noisy = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr * 3) / sr)
             + 0.02 * rng.standard_normal(sr * 3)).astype(np.float32)

    stream = StreamingEnhancer(inf)
    print(f"algorithmic latency: {stream.latency_samples / sr:.2f} s")
    out_pieces, pos = [], 0
    while pos < len(noisy):
        n = int(rng.integers(800, 6000))       # a "microphone" burst
        piece = stream.feed(noisy[pos:pos + n])
        print(f"fed {n:5d} samples -> {len(piece):5d} finalized")
        out_pieces.append(piece)
        pos += n
    out_pieces.append(stream.flush())
    streamed = np.concatenate(out_pieces)
    print(f"flushed; stream RTF {stream.last_rtf:.3f} "
          f"({1 / stream.last_rtf:.0f}x realtime serial)")

    offline = inf.overlapped_chunk(noisy)
    assert np.array_equal(streamed, offline), \
        "the streamed output differs from overlapped_chunk"
    print("streamed output is bit-identical to offline overlapped_chunk")
    return {"streamed": streamed, "offline": offline,
            "rtf": stream.last_rtf}


if __name__ == "__main__":
    main()
