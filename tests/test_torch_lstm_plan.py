"""The launch plan of the LSTM forward scans (kernels A, B and C of
generative_audio_torch/csrc/lstm_scan.cu, thread-block clusters): the
layout's shared bytes, `plan_scan` at the model shapes, `scan_hidden` (the
units a wrapper pads H to), the plan `_launch` appends and the instance
flags of the occupancy query. All plain Python; the card's occupancy is an
input, given here as the H100's. No JAX and no card needed."""
import re

import pytest
import torch

from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import lstm as tl

torch.set_num_threads(2)

SMEM_LIMIT = 232448           # bytes a CTA may opt in to on an H100
# The shapes the models launch kernels A-C at, (H, rows): FullSubNet+'s
# sub-band LSTM (batch 8 x 10 s and its ragged count, the training batch and
# its ragged count, one 10 s clip or a chunk of a 30 s one) and FullSubNet
# v1-LSTM's full band (one clip, batch 8, the training batch of 18).
MODEL_SHAPES = [(384, 2056), (384, 2047), (384, 2304), (384, 2295),
                (384, 257), (512, 1), (512, 8), (512, 18)]
# The layout's geometry, (H, C): the W_hh^T slice, the bytes each row of R
# adds (two bf16 h rows, fp32 c, two steps of gates) and the most rows per
# cluster that fit SMEM_LIMIT.
GEOMETRY = [(384, 16, 75264, 2048, 64), (384, 8, 150528, 2528, 32),
            (512, 16, 133120, 2720, 32)]


def h100_clusters(cluster, rows):
    """cudaOccupancyMaxActiveClusters as an H100 SXM gives it for one CTA
    per SM: 132 SMs, 8 clusters of 16 or 16 of 8."""
    return 128 // cluster


@pytest.mark.parametrize("hsz,batch", MODEL_SHAPES)
def test_scan_plan_fits_the_card(hsz, batch):
    plan = tl.plan_scan(hsz, batch, h100_clusters)
    assert plan.cluster in (8, 16)            # 16 with the non-portable flag
    assert hsz % (8 * plan.cluster) == 0      # groups of 8 units per CTA
    assert plan.rows % 16 == 0                # whole m16 tiles
    assert plan.smem_bytes == tl.scan_smem_bytes(hsz, plan.cluster, plan.rows)
    assert plan.smem_bytes <= SMEM_LIMIT
    # the clusters cover the rows and none is empty
    assert plan.clusters * plan.rows >= batch
    assert (plan.clusters - 1) * plan.rows < batch
    assert plan.active == h100_clusters(plan.cluster, plan.rows)
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.launch_args == (plan.cluster, plan.rows, plan.smem_bytes)
    # the model widths need no padding
    assert tl.scan_hidden(hsz) == hsz


@pytest.mark.parametrize("hsz,cluster,w_slice,per_row,max_rows", GEOMETRY)
def test_scan_smem_follows_the_layout(hsz, cluster, w_slice, per_row,
                                      max_rows):
    """4U (H + 8) x 2 B of W^T slice, and per row 2 (H + 8) x 2 B of bf16 h,
    4U B of fp32 c and 2 x 4U x 2 B of gates, U = H / C."""
    assert tl.scan_smem_bytes(hsz, cluster, 0) == w_slice
    for rows in (16, 32, max_rows):
        assert tl.scan_smem_bytes(hsz, cluster, rows) == w_slice + per_row * rows
    assert tl.scan_smem_bytes(hsz, cluster, max_rows) <= SMEM_LIMIT
    assert tl.scan_smem_bytes(hsz, cluster, max_rows + 16) > SMEM_LIMIT


def test_scan_plan_refuses_clusters_of_8_at_h512_with_the_byte_count():
    """At H=512 a CTA of a cluster of 8 holds 256 rows of W^T (266 240 B):
    with 16 rows it needs 320 000 B, so only clusters of 16 are planned."""
    assert tl.scan_smem_bytes(512, 8, 0) == 266240
    assert tl.scan_smem_bytes(512, 8, 16) == 320000 > SMEM_LIMIT
    plan = tl.plan_scan(512, 8, h100_clusters)
    assert plan.cluster == 16 and plan.rows == 16 and plan.clusters == 1
    with pytest.raises(ValueError, match=r"C=8: 320000 bytes of shared "
                                         r"memory at 16 rows, over 232448"):
        tl.plan_scan(512, 8, lambda cluster, rows: 0)


def test_scan_step_model():
    """scan_step_us grows with the busiest warp's item rounds (one warp per
    m16 x 8-unit item, at most 18 warps) and with the exchange's stores."""
    # H=384, C=16: 3 groups a tile; 64 rows are 12 items, one round
    assert tl.scan_step_us(384, 16, 64) == pytest.approx(
        tl._STEP_US + 64 * 3 * 15 * tl._STORE_US)
    # H=384, C=8: 6 groups a tile; 32 rows are 12 items, one round
    assert tl.scan_step_us(384, 8, 32) == pytest.approx(
        tl._STEP_US + 32 * 6 * 7 * tl._STORE_US)
    # H=512, C=16: 4 groups a tile; 80 rows would be 20 items, two rounds
    assert tl.scan_step_us(512, 16, 80) == pytest.approx(
        tl._STEP_US + tl._ROUND_US + 80 * 4 * 15 * tl._STORE_US)
    assert tl.scan_step_us(384, 16, 32) < tl.scan_step_us(384, 16, 64)


def test_scan_plan_takes_the_least_modelled_time():
    """The sub-band plans are the least waves x step time over every
    cluster size and row count that fits, and the card's occupancy sets
    the waves."""
    for batch in (2056, 2304, 257):
        plan = tl.plan_scan(384, batch, h100_clusters)
        best = plan.waves * tl.scan_step_us(384, plan.cluster, plan.rows)
        for cluster in tl.CLUSTER_SIZES:
            for rows in range(16, 16 * 8 + 1, 16):
                if tl.scan_smem_bytes(384, cluster, rows) > SMEM_LIMIT:
                    continue
                waves = -(-(-(-batch // rows)) // h100_clusters(cluster, rows))
                assert best <= waves * tl.scan_step_us(384, cluster, rows) \
                    + 1e-9
    one = tl.plan_scan(384, 257, lambda c, r: 7 if c == 16 else 15)
    assert one.waves == -(-one.clusters // one.active)
    with pytest.raises(ValueError, match="no multiple of"):
        tl.plan_scan(40, 4, h100_clusters)
    with pytest.raises(ValueError):
        tl.plan_scan(384, 0, h100_clusters)


@pytest.mark.parametrize("hsz,padded", [(20, 64), (64, 64), (100, 128),
                                        (200, 256), (256, 256), (320, 320),
                                        (384, 384), (400, 512), (512, 512)])
def test_scan_hidden_pads_to_a_cluster_multiple(hsz, padded):
    """The least multiple of 8 C at or above H whose CTA fits: 64 (C=8)
    while a slice of 8 CTAs fits, else 128 (C=16); at H=400 the next
    multiple of 64, 448, does not fit a cluster of 8 (251 392 B at 16 rows),
    so the layer runs at 512 on a cluster of 16."""
    assert tl.scan_hidden(hsz) == padded
    assert tl.scan_smem_bytes(448, 8, 16) == 251392 > SMEM_LIMIT
    plan = tl.plan_scan(padded, 40, h100_clusters)
    assert padded % (8 * plan.cluster) == 0


def test_scan_hidden_refuses_what_no_cluster_holds():
    """No cluster holds H = 1024: scan_hidden raises, and the wrappers take
    plan_forward's route there (the streamed cluster, or within
    single_block_forwards() the single block at H padded to 16); at H = 384
    the resident cluster."""
    with pytest.raises(ValueError, match="too large for the cluster scan"):
        tl.scan_hidden(1024)

    def route(hsz):
        return tl.plan_forward(
            "LSTM", hsz, 18, tl.scan_smem_bytes, tl.block_smem_bytes,
            tl.block_step_us,
            lambda res: tl.plan_stream_scan(hsz, 18, lambda *a: 8, res))

    assert route(1024)[:2] == (1024, "_stream")
    with tl.single_block_forwards():
        assert route(1024) == (1024, "_block", None)
        assert route(1000) == (1008, "_block", None)
    assert route(384) == (384, "", None)


def test_forward_launches_carry_the_plan(monkeypatch):
    """Kernels A-C's C functions end in the plan: `_launch` appends
    card_scan_plan's (cluster, rows, shared bytes) for (H, B) of the call
    with the instance's flags; kernel D's end in card_bwd_scan_plan's
    (cluster, rows, resident, shared bytes; without the wide cluster, whose
    entry takes other operands) and kernel G's cluster's in
    card_chains_scan_plan's (cluster, rows, resident, arrangement, shared
    bytes); other entries pass as they are."""
    calls, plans = [], []
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))

    def fake_plan(device, hsz, batch, out_dtype, carry, train):
        plans.append((hsz, batch, out_dtype, carry, train))
        return tl.plan_scan(hsz, batch, h100_clusters)

    def fake_bwd_plan(device, hsz, batch):
        plans.append((hsz, batch))
        return tl.plan_bwd_scan(hsz, batch, lambda c, r, res:
                                h100_clusters(c, r))

    def fake_chains_plan(device, hsz, batch, n_chains):
        plans.append((hsz, batch, n_chains))
        return tl.plan_chains_scan(hsz, batch, n_chains, lambda c, r, res, a:
                                   h100_clusters(c, r))

    monkeypatch.setattr(tl, "card_scan_plan", fake_plan)
    monkeypatch.setattr(tl, "card_bwd_scan_plan", fake_bwd_plan)
    monkeypatch.setattr(tl, "card_chains_scan_plan", fake_chains_plan)
    x = torch.zeros(2, 16)
    tl._launch("lstm_scan_fwd", x, x, x, 1, 628, 2056, 384, 1)
    tl._launch("lstm_scan_fwd_carry", x, x, x, x, x, x, x, 0, 64, 18, 512, 0)
    tl._launch("lstm_scan_fwd_train", x, x, x, x, 195, 2304, 384, 0)
    tl._launch("lstm_scan_bwd", x, x, x, x, x, x, x, x, 195, 2304, 384, 0)
    sub, full, train = (tl.plan_scan(384, 2056, h100_clusters),
                        tl.plan_scan(512, 18, h100_clusters),
                        tl.plan_scan(384, 2304, h100_clusters))
    assert calls[0] == ("lstm_scan_fwd",
                        (x, x, x, 1, 628, 2056, 384, 1, *sub.launch_args))
    assert calls[1] == ("lstm_scan_fwd_carry",
                        (x, x, x, x, x, x, x, 0, 64, 18, 512, 0,
                         *full.launch_args))
    assert calls[2] == ("lstm_scan_fwd_train",
                        (x, x, x, x, 195, 2304, 384, 0, *train.launch_args))
    with tl.resident_backwards():   # the resident entry's default plan
        bwd = tl.plan_bwd_scan(384, 2304, lambda c, r, res:
                               h100_clusters(c, r))
    assert calls[3] == ("lstm_scan_bwd",
                        (x, x, x, x, x, x, x, x, 195, 2304, 384, 0,
                         *bwd.launch_args))
    tl._launch("lstm_scan_bwd_chains", x, x, x, x, x, x, x, 194, 2560, 384, 2)
    chains = tl.plan_chains_scan(384, 2560, 2, lambda c, r, res, a:
                                 h100_clusters(c, r))
    assert calls[4] == ("lstm_scan_bwd_chains",
                        (x, x, x, x, x, x, x, 194, 2560, 384, 2,
                         *chains.launch_args))
    assert len(chains.launch_args) == 5
    tl._launch("lstm_scan_bwd_chains_block", x, x, x, x, x, x, x, 6, 37, 32,
               4, 30720)
    assert calls[5] == ("lstm_scan_bwd_chains_block",
                        (x, x, x, x, x, x, x, 6, 37, 32, 4, 30720))
    assert plans == [(384, 2056, torch.float32, False, False),
                     (512, 18, torch.bfloat16, True, False),
                     (384, 2304, torch.bfloat16, False, True),
                     (384, 2304), (384, 2560, 2)]


def test_card_plan_asks_for_the_instance(monkeypatch):
    """card_scan_plan asks the occupancy query of csrc/lstm_scan.cu with the
    instance's flags (out_f32, carry, train) at the call's H."""
    asked = []

    def fake_max(source, index, instance, hsz, cluster, rows):
        asked.append((source, index, instance, hsz))
        return h100_clusters(cluster, rows)

    monkeypatch.setattr(tl, "_max_clusters", fake_max)
    tl.card_scan_plan.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        for kw, flags in ((dict(), (0, 0, 0)),
                          (dict(out_dtype=torch.float32, carry=True),
                           (1, 1, 0)),
                          (dict(train=True), (0, 0, 1))):
            asked.clear()
            plan = tl.card_scan_plan(dev, 384, 257, **kw)
            assert plan == tl.plan_scan(384, 257, h100_clusters)
            assert set(asked) == {("lstm_scan", 0, flags, 384)}
    finally:
        tl.card_scan_plan.cache_clear()


def test_sources_match_their_declared_signatures():
    """Without a compiler: lstm_scan.cu's entries and its occupancy query
    take as many arguments as ops/_cuda.py declares, the entries end in the
    plan and the stream, and the layout's byte count in the source is the
    planner's."""
    text = (_cuda.CSRC / "lstm_scan.cu").read_text()
    entries = {**_cuda._SIGNATURES["lstm_scan"],
               **_cuda._QUERIES["lstm_scan"]}
    assert set(entries) == {"lstm_scan_fwd", "lstm_scan_fwd_carry",
                            "lstm_scan_fwd_train", "lstm_scan_max_clusters",
                            "lstm_scan_fwd_stream",
                            "lstm_scan_fwd_carry_stream",
                            "lstm_scan_fwd_train_stream",
                            "lstm_scan_stream_max_clusters"}
    for name, argtypes in entries.items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert len(names) == len(argtypes), name
        if name.endswith("_stream"):
            assert names[-6:] == ["cluster", "rows", "resident", "stages",
                                  "smem_bytes", "stream"]
        elif not name.endswith("_max_clusters"):
            assert names[-4:] == ["cluster", "rows", "smem_bytes", "stream"]
    query = re.search(r"\bint lstm_scan_max_clusters\(([^)]*)\)", text)
    assert " ".join(query.group(1).split()) == (
        "int out_f32, int carry, int train, int H, int cluster, int rows, "
        "int* n")
    query = re.search(r"\bint lstm_scan_stream_max_clusters\(([^)]*)\)",
                      text)
    assert " ".join(query.group(1).split()) == (
        "int out_f32, int carry, int train, int resident, int stages, int H, "
        "int cluster, int rows, int* n")
    body = re.search(r"size_t cluster_smem\(int H, int C, int R\) \{(.*?)\}",
                     text, re.S).group(1)
    assert "(4 * U + 2 * r) * hs * 2 + r * U * 4 + 2 * r * 4 * U * 2" in body
    assert set(_cuda._QUERIES) == {"lstm_scan", "gru_scan", "lstm_scan_bwd",
                                   "gru_scan_bwd", "lstm_scan_staged",
                                   "lstm_scan_bwd_chains", "scan_bwd_stream",
                                   "lstm_staged_stream", "lstm_scan_wide",
                                   "lstm_scan_bwd_wide", "gru_scan_bwd_wide",
                                   "gru_scan_wide"}
