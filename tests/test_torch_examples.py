"""The port's three examples (generative_audio_torch/examples/), each through
its `main` with --device cpu and the fewest steps that run every part: the
enhancement demo's training, Inferencer and metrics, the streaming demo's
bit-identity with overlapped_chunk, and the inpainting demo's principal-angle
table."""
import re

import numpy as np
import torch

from generative_audio_torch.examples import (
    enhance_demo, nppc_inpainting_demo, streaming_demo)

torch.set_num_threads(2)
NUMBER = r"(-?\d+\.\d+|nan|inf)"


def test_enhance_demo(capsys):
    got = enhance_demo.main(["--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^step 1: loss=\d+\.\d+$", out, re.M)
    printed = dict(re.findall(rf"^(SI-SDR \w+|STOI \w+)\s*: *{NUMBER}", out,
                              re.M))
    assert set(printed) == {"SI-SDR noisy", "SI-SDR enhanced", "STOI noisy",
                            "STOI enhanced"}
    assert all(np.isfinite(float(v)) for v in printed.values())
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == 1
    assert 0 <= got["STOI enhanced"] <= 1


def test_streaming_demo(capsys):
    got = streaming_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "streamed output is bit-identical to offline overlapped_chunk" in out
    assert np.array_equal(got["streamed"], got["offline"])
    assert got["streamed"].shape == (48000,)
    assert np.isfinite(got["streamed"]).all()
    assert np.abs(got["streamed"]).max() > 0
    finalized = re.findall(r"^fed +\d+ samples -> +(\d+) finalized$", out,
                           re.M)
    assert len(finalized) > 1 and int(max(finalized, key=int)) > 0


def test_nppc_inpainting_demo(capsys):
    got = nppc_inpainting_demo.main(["--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    table = re.search(r"^  principal_angles: \[(.*)\]$", out, re.M)
    assert table is not None
    angles = [float(a) for a in table.group(1).split()]
    assert len(angles) == 3
    assert all(0 <= a <= 90 for a in angles)
    np.testing.assert_allclose(angles, got["principal_angles"], atol=1e-3)
    for method in ("nppc", "mc_dropout"):
        assert re.search(rf"^  {method}: \{{'rmse': ", out, re.M)
        assert np.isfinite([got[method]["rmse"],
                            got[method]["residual_error"]]).all()
