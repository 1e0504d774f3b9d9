"""The launch planners of the GRU kernels (generative_audio_torch/ops/gru.py):
`plan_scan` for the cluster forward scan (csrc/gru_scan.cu) and `plan_dwhh`
for the dW_hh contraction (csrc/gru_scan_bwd.cu). Both are plain Python; the
card's occupancy is an input, given here as the H100's. No JAX and no card
needed."""
import re

import pytest
import torch

from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl

torch.set_num_threads(2)

SMEM_LIMIT = 232448           # bytes a CTA may opt in to on an H100
# The shapes the models launch the forward scan at, (H, rows): FullSubNet v1's
# sub-band GRU (batch 8 x 10 s and its ragged count, the training batch and
# its ragged count, one 10 s clip or a chunk of a 30 s one) and its full-band
# GRU (one clip, batch 8, the training batch of 18).
MODEL_SHAPES = [(384, 2056), (384, 2047), (384, 2304), (384, 2295),
                (384, 257), (512, 1), (512, 8), (512, 18)]
# The contraction's shapes, (H, N): the sub-band training layer (194 x 2304
# shifted rows, and the ragged batch) and the full-band one (194 x 18).
DWHH_SHAPES = [(384, 194 * 2304), (384, 194 * 2295), (512, 194 * 18),
               (384, 1), (16, 114)]


def h100_clusters(cluster, rows):
    """cudaOccupancyMaxActiveClusters as an H100 SXM gives it for one CTA
    per SM: 132 SMs, 8 clusters of 16 or 16 of 8."""
    return 128 // cluster


@pytest.mark.parametrize("hsz,batch", MODEL_SHAPES)
def test_scan_plan_fits_the_card(hsz, batch):
    plan = tg.plan_scan(hsz, batch, h100_clusters)
    assert plan.cluster in (8, 16)            # 16 with the non-portable flag
    assert hsz % (8 * plan.cluster) == 0      # groups of 8 units per CTA
    assert plan.rows % 16 == 0                # whole m16 tiles
    assert plan.smem_bytes == tg.scan_smem_bytes(hsz, plan.cluster, plan.rows)
    assert plan.smem_bytes <= SMEM_LIMIT
    # the clusters cover the rows and none is empty
    assert plan.clusters * plan.rows >= batch
    assert (plan.clusters - 1) * plan.rows < batch
    assert plan.active == h100_clusters(plan.cluster, plan.rows)
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.launch_args == (plan.cluster, plan.rows, plan.smem_bytes)


def test_scan_plan_refuses_clusters_of_8_at_h512_with_the_byte_count():
    plan = tg.plan_scan(512, 8, h100_clusters)
    assert plan.cluster == 16 and plan.rows == 16 and plan.clusters == 1
    # 192 rows of W^T and two 16-row h buffers at 520 bf16 a row, 16 x 64
    # fp32 h, two steps of 16 x 192 bf16 gates and 192 fp32 biases
    assert tg.scan_smem_bytes(512, 8, 16) == 250112 > SMEM_LIMIT
    with pytest.raises(ValueError, match=r"C=8: 250112 bytes of shared "
                                         r"memory at 16 rows, over 232448"):
        tg.plan_scan(512, 8, lambda cluster, rows: 0)


def test_scan_smem_follows_the_layout():
    """The W slice, the two bf16 h buffers and the fp32 own h of the design
    notes (csrc/gru_scan.cu): 99 840 + 2 080 R + 128 R at H=512, C=16 (plus
    two steps of gates, 2 x 192 R, and 384 bytes of biases), 56 448 +
    1 568 R + 96 R (+ 2 x 144 R + 288) at H=384."""
    assert tg.scan_smem_bytes(512, 16, 32) == 99840 + 2080 * 32 + 128 * 32 \
        + 2 * 192 * 32 + 384
    assert tg.scan_smem_bytes(384, 16, 80) == 56448 + 1568 * 80 + 96 * 80 \
        + 2 * 144 * 80 + 288
    assert tg.scan_smem_bytes(384, 16, 80) <= SMEM_LIMIT
    assert tg.scan_smem_bytes(384, 16, 96) > SMEM_LIMIT


def test_scan_step_model():
    """scan_step_us grows with the busiest warp's item rounds (one warp per
    m16 x 8-unit item, at most 18 warps) and with the exchange's stores."""
    # H=384, C=8: 6 groups a tile; 48 rows are 18 items, one round
    assert tg.scan_step_us(384, 8, 48) == pytest.approx(
        tg._STEP_US + 48 * 6 * 7 * tg._STORE_US)
    # H=384, C=16: 3 groups a tile; 112 rows are 21 items, two rounds
    assert tg.scan_step_us(384, 16, 112) == pytest.approx(
        tg._STEP_US + tg._ROUND_US + 112 * 3 * 15 * tg._STORE_US)
    # H=512, C=16: 4 groups a tile; 16 rows are one round
    assert tg.scan_step_us(512, 16, 16) == pytest.approx(
        tg._STEP_US + 16 * 4 * 15 * tg._STORE_US)
    assert tg.scan_step_us(384, 8, 32) < tg.scan_step_us(384, 8, 48)


def test_scan_plan_weighs_occupancy():
    """Fewer clusters of 16 at once (a card whose GPCs hold only 7) do not
    change the one-cluster full band, and the sub-band plan never needs
    more waves than its clusters allow."""
    for hsz, batch in MODEL_SHAPES:
        plan = tg.plan_scan(hsz, batch, lambda c, r: 7 if c == 16 else 16)
        assert plan.waves == -(-plan.clusters // plan.active)
    full = tg.plan_scan(512, 18, lambda c, r: 7)
    assert full.cluster == 16 and full.waves == 1
    # the sub-band batch takes the plan of least modelled time
    sub = tg.plan_scan(384, 2056, h100_clusters)
    for cluster in (8, 16):
        for rows in range(16, 16 * 8 + 1, 16):
            if tg.scan_smem_bytes(384, cluster, rows) > SMEM_LIMIT:
                continue
            waves = -(-(-(-2056 // rows)) // h100_clusters(cluster, rows))
            assert sub.waves * tg.scan_step_us(384, sub.cluster, sub.rows) \
                <= waves * tg.scan_step_us(384, cluster, rows) + 1e-9
    with pytest.raises(ValueError, match="no multiple of"):
        tg.plan_scan(40, 4, h100_clusters)
    with pytest.raises(ValueError):
        tg.plan_scan(384, 0, h100_clusters)


@pytest.mark.parametrize("hsz,n", DWHH_SHAPES)
def test_dwhh_slices_cover_the_rows(hsz, n):
    """The slices of the full tiles and of the narrow ones each cover the N
    rows in whole 64-row stages, none empty, as the kernel cuts them; the
    working CTAs fill at most one wave of the card's SMs; the partials are
    `slices`, summed in a fixed order (slice 0 first) by the wrapper."""
    plan = tg.plan_dwhh(n, hsz)
    full, narrow, _ = tg._dwhh_tiles(hsz)
    assert plan.tiles == full + narrow and plan.narrow_tiles == narrow
    assert 1 <= plan.narrow_slices <= plan.slices
    for per, count in ((plan.rows_per_slice, plan.slices),
                       (plan.narrow_rows, plan.narrow_slices)):
        bounds = [(z * per, min(n, (z + 1) * per)) for z in range(count)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (_, end), (begin, _) in zip(bounds, bounds[1:]):
            assert end == begin and begin % 64 == 0   # whole 64-row stages
        assert all(end > begin for begin, end in bounds)   # none empty
        assert per % 64 == 0
        # the kernel's own rows per slice for this count
        assert per == -(-(-(-n // count)) // 64) * 64
    assert (full * plan.slices + narrow * plan.narrow_slices <= tg.H100_SMS
            or plan.slices == 1)
    assert plan.in_flight == 1 and plan.launch_args == (
        plan.slices, plan.narrow_slices, 1)
    assert plan.us == tg.dwhh_us(n, hsz, plan.slices, plan.narrow_slices)


def test_dwhh_plan_at_the_model_shapes():
    """At the sub-band training shape the 12 full tiles take 9 slices and
    dhn's 3 ragged ones (128 columns) 8, 132 CTAs, where the first design's
    plan (plan_dwhh_first) ran 15 x 8 = 120; at the full band 24 tiles take
    4 slices where the first design took one. The narrow tiles fill what
    the full tiles leave of the card, and no other slice count of the full
    tiles models faster within one wave."""
    sub = tg.plan_dwhh(194 * 2304, 384)
    assert (sub.tiles, sub.slices, sub.narrow_tiles, sub.narrow_slices) == (
        15, 9, 3, 8)
    full = tg.plan_dwhh(194 * 18, 512)
    assert (full.tiles, full.slices, full.narrow_tiles) == (24, 4, 0)
    for n, hsz, plan in ((194 * 2304, 384, sub), (194 * 18, 512, full)):
        f, w, _ = tg._dwhh_tiles(hsz)
        assert f * plan.slices + w * plan.narrow_slices <= tg.H100_SMS
        if w:
            assert (plan.narrow_slices == plan.slices or f * plan.slices
                    + w * (plan.narrow_slices + 1) > tg.H100_SMS)
        for slices in range(1, (tg.H100_SMS - w) // f + 1):
            narrow = (max(1, min(slices, (tg.H100_SMS - f * slices) // w))
                      if w else slices)
            assert plan.us <= tg.dwhh_us(n, hsz, slices, narrow) + 1e-9
    first = tg.plan_dwhh_first(194 * 2304, 384)
    assert (first.tiles, first.slices, first.narrow_slices,
            first.in_flight) == (15, 8, 8, 0)
    first = tg.plan_dwhh_first(194 * 18, 512)
    assert (first.tiles, first.slices, first.in_flight) == (24, 1, 0)
    assert first.launch_args == (1, 1, 0)


def test_forward_launches_carry_the_plan(monkeypatch):
    """The forward entries' C functions end in the plan: `_launch` appends
    card_scan_plan's (cluster, rows, shared bytes) for (H, B) of the call
    and the instance's output type; other entries pass as they are."""
    calls = []
    monkeypatch.setattr(tg, "_launch_entry",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tg, "card_scan_plan",
                        lambda device, hsz, batch, out_dtype, carry:
                        tg.plan_scan(hsz, batch, h100_clusters))
    x = torch.zeros(2, 16)
    tg._launch("gru_scan_fwd", x, x, x, x, 0, 628, 2056, 384, 1)
    tg._launch("gru_scan_fwd_carry", x, x, x, x, x, x, 1, 64, 18, 512, 0)
    tg._launch("gru_scan_bwd_dwhh", x, x, x, x, 5, 16)
    sub, full = tg.plan_scan(384, 2056, h100_clusters), \
        tg.plan_scan(512, 18, h100_clusters)
    assert calls[0] == ("gru_scan_fwd",
                        (x, x, x, x, 0, 628, 2056, 384, 1, *sub.launch_args))
    assert calls[1] == ("gru_scan_fwd_carry", (x, x, x, x, x, x, 1, 64, 18,
                                               512, 0, *full.launch_args))
    assert calls[2] == ("gru_scan_bwd_dwhh",
                        (x, x, x, x, 5, 16, *tg.plan_dwhh(5, 16).launch_args))


def test_contraction_launch_uses_the_plan(monkeypatch):
    """gru_dwhh on the kernel's branch hands the kernel plan_dwhh's plan
    (or the one it is given) and sums that many partials."""
    seen = {}

    def fake_launch(name, h_prev, dgx, dhn, part, n, hsz, plan):
        seen.update(name=name, n=n, slices=plan.slices, parts=part.shape[0])
        part.zero_()
        tl.launch_counts[name] += 1

    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    n, hsz = 20 * 16 * 12 + 5, 16
    h_prev = torch.zeros(n, hsz, dtype=torch.bfloat16)
    dgx = torch.zeros(n, 3 * hsz, dtype=torch.bfloat16)
    dhn = torch.zeros(n, hsz, dtype=torch.bfloat16)
    out = tg.gru_dwhh(h_prev, dgx, dhn)
    want = tg.plan_dwhh(n, hsz).slices
    assert want > 1
    assert seen == dict(name="gru_scan_bwd_dwhh", n=n, slices=want, parts=want)
    assert out.shape == (hsz, 3 * hsz)
    assert tl.launch_counts["gru_scan_bwd_dwhh"] == 1
    first = tg.plan_dwhh_first(n, hsz)
    tg.gru_dwhh(h_prev, dgx, dhn, plan=first)
    assert seen["slices"] == seen["parts"] == first.slices
    assert tl.launch_counts["gru_scan_bwd_dwhh"] == 2


def test_queries_match_their_declared_signatures():
    """Without a compiler: each query of a source takes as many arguments as
    ops/_cuda.py declares for it, and the forward entries end in the plan."""
    for source, queries in _cuda._QUERIES.items():
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        for name, argtypes in queries.items():
            params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
            assert len(params.split(",")) == len(argtypes), name
    text = (_cuda.CSRC / "gru_scan.cu").read_text()
    for entry in ("gru_scan_fwd", "gru_scan_fwd_carry"):
        params = re.search(rf"\bint {entry}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1] for p in params.split(",")]
        assert names[-4:] == ["cluster", "rows", "smem_bytes", "stream"]
