"""The launch plans of the two staged LSTM scans, thread-block clusters of
generative_audio_torch/csrc/lstm_scan_staged.cu: kernel E
(lstm_scan_fwd_unrolled, the gates arriving K steps at a time) and kernel F
(lstm_layer_fwd, the input projection inside the scan), with kernel F's
single-block route (csrc/lstm_layer_block.cu) above what a cluster holds.

The layouts' shared bytes against the sources, the plans at the shapes the
scripts and FullSubNet+'s sub-band layers give them (the card's occupancy
faked as an H100 SXM gives it), the route by H, the zero padding of H the
wrappers hand the kernels, and the plan `_launch` appends. All plain Python:
no JAX and no card needed.
"""
import re

import pytest
import torch

from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import lstm as tl
from test_torch_bwd_plan import _c_function

torch.set_num_threads(2)
SMEM_LIMIT = 232448           # bytes a CTA may opt in to on an H100
SUB_BAND_F = (34, 384)        # the sub-band layers' input widths


def unfragment(wf, rows, cols):
    """W [rows, cols] back from ops.lstm._fragment_rows's MMA fragment
    order."""
    return wf.reshape(rows // 8, cols // 32, 8, 4, 2, 2, 2).permute(
        0, 2, 1, 4, 5, 3, 6).reshape(rows, cols)


def h100_clusters(cluster, rows):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM."""
    return 15 if cluster == 8 else 7


def _source_unrolled(hsz, cluster, rows, k):
    expr = _c_function("lstm_scan_staged.cu",
                       "size_t unrolled_smem(int H, int C, int R, int K)")
    return eval(expr, {}, dict(U=hsz // cluster, hs=hsz + 8, r=rows, K=k))


def _source_layer(hsz, cluster, rows):
    expr = _c_function("lstm_scan_staged.cu",
                       "size_t layer_smem(int H, int C, int R)")
    return eval(expr, {}, dict(U=hsz // cluster, hs=hsz + 8, r=rows))


@pytest.mark.parametrize("hsz,cluster,rows,k", [
    (384, 8, 16, 2), (384, 8, 16, 4), (384, 16, 32, 4), (384, 16, 48, 4),
    (512, 16, 16, 4), (64, 8, 64, 2)])
def test_unrolled_smem_is_the_source_layout(hsz, cluster, rows, k):
    got = tl.unrolled_smem_bytes(hsz, cluster, rows, k)
    assert got == _source_unrolled(hsz, cluster, rows, k)
    assert got % 16 == 0


def test_unrolled_layouts_that_fit():
    """A two-group ring beside kernel A's layout: at H=384 a cluster of 8
    over 32 rows does not fit even at K=2; 16 rows of 8 CTAs and 32 or 48
    rows of 16 CTAs do at K=4 (144 bytes on top of the regions: the ring's
    128 bytes of alignment slack and two mbarriers)."""
    assert tl.unrolled_smem_bytes(384, 8, 32, 2) == 256000 + 144 > SMEM_LIMIT
    assert tl.unrolled_smem_bytes(384, 8, 16, 4) == 227840 + 144 <= SMEM_LIMIT
    assert tl.unrolled_smem_bytes(384, 16, 32, 4) == 177664 + 144
    assert tl.unrolled_smem_bytes(384, 16, 48, 4) <= SMEM_LIMIT
    assert tl.unrolled_smem_bytes(384, 16, 64, 4) > SMEM_LIMIT


@pytest.mark.parametrize("hsz,cluster,rows", [
    (384, 8, 16), (384, 8, 32), (384, 8, 48), (384, 16, 48), (384, 16, 96),
    (512, 16, 16), (64, 8, 16)])
def test_layer_smem_is_the_source_layout(hsz, cluster, rows):
    got = tl.layer_smem_bytes(hsz, cluster, rows)
    assert got == _source_layer(hsz, cluster, rows)
    assert got % 16 == 0


def test_layer_layouts_that_fit():
    """Kernel F keeps c and the x product's accumulators in registers and
    reads W_ih^T from L2, so its CTA holds only the W_hh^T slice and the h
    buffers, whatever F: a cluster of 8 takes 48 rows at H=384, one of 16
    takes 96."""
    assert tl.layer_smem_bytes(384, 8, 32) == 200704
    assert tl.layer_smem_bytes(384, 8, 48) == 225792 <= SMEM_LIMIT
    assert tl.layer_smem_bytes(384, 8, 64) > SMEM_LIMIT
    assert tl.layer_smem_bytes(384, 16, 96) <= SMEM_LIMIT
    assert tl.layer_smem_bytes(384, 16, 112) > SMEM_LIMIT


@pytest.mark.parametrize("hsz,f", [(384, 34), (384, 384), (768, 34),
                                   (1024, 6)])
def test_layer_block_smem_is_the_source_layout(hsz, f):
    text = (_cuda.CSRC / "lstm_layer_block.cu").read_text()
    body = re.search(r"inline size_t layer_block_smem\(int H, int fpad\) "
                     r"\{(.*?)\}", text, re.S).group(1)
    expr = " ".join(body.split()).replace("return", "").rstrip(";")
    expr = expr.replace("(size_t)", "").replace("sizeof(__nv_bfloat16)", "2")
    expr = expr.replace("sizeof(float)", "4")
    want = eval(expr, {}, dict(H=hsz, fpad=-(-f // 16) * 16, ROWS=16, PAD=8))
    assert tl.layer_block_smem_bytes(hsz, f) == want
    # the parent's kernel F: 74 752 B at H=384, F=384
    assert tl.layer_block_smem_bytes(384, 384) == 74752


def _every_plan(hsz, batch, smem, step, max_items=None):
    """(modelled time, C, R) of every cluster shape that fits."""
    out = []
    for cluster in tl.CLUSTER_SIZES:
        if hsz % (8 * cluster):
            continue
        for rows in range(16, 16 * -(-batch // 16) + 1, 16):
            if smem(hsz, cluster, rows) > SMEM_LIMIT:
                continue
            if max_items and rows // 16 * hsz // cluster // 8 > max_items:
                continue
            clusters = -(-batch // rows)
            waves = -(-clusters // h100_clusters(cluster, rows))
            out.append((waves * step(hsz, cluster, rows), cluster, rows))
    return out


@pytest.mark.parametrize("batch", [2304, 2056, 2047, 257])
@pytest.mark.parametrize("k", [2, 4])
def test_unrolled_plan(batch, k):
    """Kernel E at the script's and the serving shapes: a plan of its own
    layout that fits, covers the rows, and takes the least modelled time of
    every shape that fits."""
    plan = tl.plan_unrolled(384, batch, k, h100_clusters)
    assert plan.smem_bytes == tl.unrolled_smem_bytes(384, plan.cluster,
                                                     plan.rows, k)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.rows % 16 == 0
    assert plan.clusters * plan.rows >= batch
    assert (plan.clusters - 1) * plan.rows < batch
    assert plan.waves == -(-plan.clusters // plan.active)
    best = min(_every_plan(384, batch,
                           lambda h, c, r: tl.unrolled_smem_bytes(h, c, r, k),
                           tl.unrolled_step_us))
    assert plan.waves * tl.unrolled_step_us(384, plan.cluster, plan.rows) \
        <= best[0] + 1e-9


@pytest.mark.parametrize("f", SUB_BAND_F)
@pytest.mark.parametrize("batch", [2056, 2047, 2304])
def test_layer_plan_at_the_sub_band_shapes(f, batch):
    """Kernel F at FullSubNet+'s two sub-band layers (2056 rows of one batch
    of 8 x 10 s, a ragged count, the training batch): one warp an item (at
    most 18 a CTA), its layout, and the least modelled time over every
    shape that fits."""
    plan = tl.plan_layer(384, batch, f, h100_clusters)
    assert plan.smem_bytes == tl.layer_smem_bytes(
        384, plan.cluster, plan.rows) <= SMEM_LIMIT
    assert plan.rows // 16 * 384 // plan.cluster // 8 <= 18
    assert plan.clusters * plan.rows >= batch
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.launch_args == (plan.cluster, plan.rows, plan.smem_bytes)
    step = tl.layer_step_us(384, plan.cluster, plan.rows, f)
    best = min(_every_plan(384, batch, tl.layer_smem_bytes,
                           lambda h, c, r: tl.layer_step_us(h, c, r, f), 18))
    assert plan.waves * step <= best[0] + 1e-9


def test_layer_plan_keeps_one_item_a_warp():
    """Rows that would give a CTA more than 18 items are not planned: at
    H=384 a cluster of 8 has 6 groups of units, so at most 48 rows."""
    plan = tl.plan_layer(384, 4096, 34, lambda c, r: 1000)
    assert plan.rows // 16 * 384 // plan.cluster // 8 <= 18
    with pytest.raises(ValueError, match="no cluster plan"):
        tl.plan_layer(384, 64, 34, lambda c, r: 0)


# one-cluster steps (us) measured on an H100 SXM at 700 W, T=628, H=384
# (generative_audio_torch/scripts/perf_staged_scan.py): kernel E (C, R, K)
# and kernel F (F, C, R)
MEASURED_E = {(8, 16, 4): 4.34, (16, 16, 4): 3.84, (16, 32, 4): 5.16,
              (16, 48, 4): 6.59, (8, 16, 2): 4.50, (16, 64, 2): 7.70}
MEASURED_F = {(34, 8, 32): 8.16, (34, 8, 48): 10.08, (34, 16, 80): 11.76,
              (384, 16, 32): 10.35, (384, 8, 48): 20.83, (384, 16, 64): 16.29}


def test_step_models_fit_the_sweep():
    """The fitted step models against the sweep's one-cluster steps, within
    their largest residuals (0.4 us for E, 2.7 us for F)."""
    for (c, r, _), us in MEASURED_E.items():
        assert tl.unrolled_step_us(384, c, r) == pytest.approx(us, abs=0.4)
    for (f, c, r), us in MEASURED_F.items():
        assert tl.layer_step_us(384, c, r, f) == pytest.approx(us, abs=2.7)


@pytest.mark.parametrize("f,ms", [(34, 19.018), (384, 38.986)])
def test_layer_plan_is_the_sweep_s_best(f, ms):
    """At both sub-band layers (2056 rows) the plan of least modelled time
    is the one the sweep measured fastest: C=8 x 48 rows, 3 waves (19.018
    and 38.986 ms on an H100 SXM at 700 W)."""
    plan = tl.plan_layer(384, 2056, f, h100_clusters)
    assert (plan.cluster, plan.rows, plan.waves) == (8, 48, 3)


def test_step_models_grow_with_their_work():
    """Kernel F's step grows with the x product's k-steps and with the row
    tiles that read W_ih^T; kernel E's with the exchange."""
    assert tl.layer_step_us(384, 8, 32, 384) > tl.layer_step_us(384, 8, 32, 34)
    assert tl.layer_step_us(384, 8, 48, 384) > tl.layer_step_us(384, 8, 16, 384)
    assert tl.unrolled_step_us(384, 16, 48) > tl.unrolled_step_us(384, 16, 16)


@pytest.mark.parametrize("hsz,k,padded", [
    (20, 2, 64), (100, 4, 128), (200, 4, 256), (384, 2, 384), (384, 4, 384),
    (512, 4, 512)])
def test_unrolled_hidden(hsz, k, padded):
    assert tl.unrolled_hidden(hsz, k) == padded


def test_unrolled_refuses_what_no_cluster_holds():
    """Where no cluster holds kernel E (above H=512: a CTA of 16 at 16 rows
    and K=4 needs 292 496 B at H=640) it takes its streamed cluster at H
    padded to stream_hidden's units, and within single_block_forwards() its
    single block at H padded to 16, with as many rows a block as fit (none
    at H=1120, K=4: 233 472 B at 4 rows). It refuses, on either device,
    only where not even one group of K steps fits beside a streamed CTA's
    h buffers: H=2048 runs at K=4, H=2064 needs 244 376 B (C=16, one stage,
    one group)."""
    assert tl.unrolled_smem_bytes(640, 16, 16, 4) == 292496 > tl.SMEM_LIMIT
    assert tl.unrolled_route(640, 4)[:2] == (640, "_stream")
    assert tl.unrolled_route(576, 2)[:2] == (640, "_stream")
    with tl.single_block_forwards():
        assert tl.unrolled_route(640, 4) == (640, "_block", None)
        assert tl.unrolled_route(576, 2) == (576, "_block", None)
        with pytest.raises(ValueError, match=r"single block needs 233472 B"):
            tl.unrolled_hidden(1120, 4)
    assert tl.unrolled_hidden(1120, 4) == 1152
    assert tl.unrolled_hidden(2048, 4) == 2048
    with pytest.raises(ValueError, match=r"H=2064: .*244376 B at 16 rows"):
        tl.unrolled_hidden(2064, 4)
    gates = torch.zeros(4, 2, 4 * 2064, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="244376 B"):
        tl.lstm_scan_tm(gates, torch.zeros(2064, 4 * 2064), block_t=4)


@pytest.mark.parametrize("hsz,f,route,block", [
    (8, 34, (64, ""), 16), (20, 6, (64, ""), 32), (100, 34, (128, ""), 112),
    (384, 34, (384, ""), 384), (384, 384, (384, ""), 384),
    (512, 384, (512, ""), 512), (520, 6, (640, "_stream"), 528),
    (640, 34, (640, "_stream"), 640), (1000, 384, (1024, "_stream"), 1008)])
def test_layer_route_by_hidden_size(hsz, f, route, block):
    """Kernel F takes a cluster up to H=512 and its streamed cluster above,
    at H padded to stream_hidden's units (here clusters of 16); within
    single_block_forwards() the single block, at H padded to 16."""
    hp, suffix, plan = tl.layer_route(hsz, f)
    assert (hp, suffix) == route
    assert (plan is None) == (suffix == "")
    with tl.single_block_forwards():
        assert tl.layer_route(hsz, f) == (block, "_block", None)


def test_single_block_forwards_take_the_layer_block():
    with tl.single_block_forwards():
        assert tl.layer_route(384, 34) == (384, "_block", None)
        assert tl.layer_route(20, 34) == (32, "_block", None)
    assert tl.layer_route(384, 34) == (384, "", None)


@pytest.fixture
def entries(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch faked
    (records (entry, arguments)) and the card's plans faked with an H100's
    occupancy."""
    calls = []
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tl, "card_unrolled_plan", lambda d, h, b, k:
                        tl.plan_unrolled(h, b, k, h100_clusters))
    monkeypatch.setattr(tl, "card_layer_plan", lambda d, h, b, f, dtype:
                        tl.plan_layer(h, b, f, h100_clusters))
    return calls


def _layer_operands(t_len, b, f, hsz, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(t_len, b, f, generator=gen),
            torch.randn(f, 4 * hsz, generator=gen) * 0.1,
            torch.randn(hsz, 4 * hsz, generator=gen) * 0.1,
            torch.randn(4 * hsz, generator=gen) * 0.1)


@pytest.mark.parametrize("hsz", [20, 100])
def test_layer_operands_carry_the_padding_and_the_plan(entries, hsz):
    """lstm_layer_tm at H = 20 and 100 hands kernel F H padded to 64 and
    128 with zero units in W_hh^T, in each gate block of W_ih^T and of the
    bias, W_ih^T with zero columns from F = 7 (x padded to 8) to 32 in
    fragment order, and the plan for (padded H, B, F, output type)."""
    x, w_ih, w_hh, bias = _layer_operands(3, 40, 7, hsz, seed=hsz)
    with torch.no_grad():
        out = tl.lstm_layer_tm(x, w_ih, w_hh, bias, True, torch.float32)
    (name, args), = entries
    hp = tl.layer_route(hsz, 8)[0]
    assert name == "lstm_layer_fwd" and hp == -(-hsz // 64) * 64
    xk, wif, wt, bk, buf = args[:5]
    assert args[5:11] == (True, 3, 40, 8, hp, True)
    assert args[11:] == tl.plan_layer(hp, 40, 8, h100_clusters).launch_args
    assert tuple(xk.shape) == (3, 40, 8) and not xk[..., 7:].any()
    wih_t = unfragment(wif, 4 * hp, 32)
    gates = wih_t.reshape(4, hp, 32)
    assert not gates[:, hsz:].any() and not gates[:, :, 7:].any()
    assert torch.equal(gates[:, :hsz, :7].reshape(4 * hsz, 7),
                       w_ih.t().to(torch.bfloat16))
    assert not wt.reshape(4, hp, hp)[:, hsz:].any()
    assert not wt.reshape(4, hp, hp)[:, :, hsz:].any()
    assert not bk.reshape(4, hp)[:, hsz:].any()
    assert tuple(buf.shape) == (3, 40, hp) and tuple(out.shape) == (3, 40, hsz)


def test_unrolled_operands_carry_the_padding_and_the_plan(entries):
    gates = torch.randn(4, 40, 4 * 100).to(torch.bfloat16)
    w_hh = torch.randn(100, 400) * 0.1
    out = tl.lstm_scan_tm(gates, w_hh, block_t=4)
    (name, args), = entries
    assert name == "lstm_scan_fwd_unrolled"
    assert args[3:7] == (4, 40, 128, 4)
    assert args[7:] == tl.plan_unrolled(128, 40, 4, h100_clusters).launch_args
    assert not args[0].reshape(4, 40, 4, 128)[..., 100:].any()
    assert tuple(out.shape) == (4, 40, 100)


def test_planned_wrappers_launch_the_given_plan(entries, monkeypatch):
    monkeypatch.setattr(tl, "card_unrolled_plan", None)      # not asked
    monkeypatch.setattr(tl, "card_layer_plan", None)
    plan_e = tl.plan_unrolled(384, 40, 2, lambda c, r: 1)
    plan_f = tl.plan_layer(384, 40, 34, lambda c, r: 1)
    gates = torch.zeros(4, 40, 4 * 384, dtype=torch.bfloat16)
    tl.lstm_scan_unrolled_planned_tm(gates, torch.zeros(384, 1536), plan_e, 2)
    tl.lstm_layer_planned_tm(*_layer_operands(2, 40, 34, 384, 1), plan_f)
    assert [(n, a[-len(p.launch_args):]) for (n, a), p in
            zip(entries, (plan_e, plan_f))] == [
        ("lstm_scan_fwd_unrolled", plan_e.launch_args),
        ("lstm_layer_fwd", plan_f.launch_args)]
    with pytest.raises(ValueError, match="no cluster"):
        tl.lstm_layer_planned_tm(*_layer_operands(2, 4, 6, 640, 2), plan_f)


def test_planned_wrappers_refuse_cpu_tensors():
    plan_e = tl.plan_unrolled(64, 8, 2, h100_clusters)
    plan_f = tl.plan_layer(64, 8, 6, h100_clusters)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.lstm_scan_unrolled_planned_tm(torch.zeros(2, 8, 256),
                                         torch.zeros(64, 256), plan_e, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.lstm_layer_planned_tm(*_layer_operands(2, 8, 6, 64, 3), plan_f)


def test_card_plans_ask_for_the_instance(monkeypatch):
    """card_unrolled_plan asks lstm_scan_staged_max_clusters with (k, 0),
    card_layer_plan with (1, out_f32)."""
    asked = []

    def fake_max(source, index, instance, hsz, cluster, rows):
        asked.append((source, instance, hsz))
        return h100_clusters(cluster, rows)

    monkeypatch.setattr(tl, "_max_clusters", fake_max)
    tl.card_unrolled_plan.cache_clear()
    tl.card_layer_plan.cache_clear()
    try:
        dev = torch.device("cuda", 0)
        assert tl.card_unrolled_plan(dev, 384, 2304, 4) == \
            tl.plan_unrolled(384, 2304, 4, h100_clusters)
        assert set(asked) == {("lstm_scan_staged", (4, 0), 384)}
        asked.clear()
        assert tl.card_layer_plan(dev, 384, 2056, 34, torch.float32) == \
            tl.plan_layer(384, 2056, 34, h100_clusters)
        assert set(asked) == {("lstm_scan_staged", (1, 1), 384)}
    finally:
        tl.card_unrolled_plan.cache_clear()
        tl.card_layer_plan.cache_clear()


def test_fragment_rows_order():
    """Lane (grp, tq) of row group G holds, for k-step pair p, columns 32p +
    16kk + 8half + 2tq + e of row 8G + grp in the order (kk, half, e): the
    B fragments (b0, b1) of k-steps 2p and 2p + 1 (kernel F's W_ih^T and the
    backwards' W_hh^T); unfragment inverts it."""
    w = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    frag = tl._fragment_rows(w)
    for g in range(2):
        for p in range(2):
            for grp in range(8):
                for tq in range(4):
                    got = frag[g, p, grp, tq].flatten().tolist()
                    want = [w[8 * g + grp, 32 * p + 16 * kk + 8 * half
                              + 2 * tq + e].item()
                            for kk in (0, 1) for half in (0, 1) for e in (0, 1)]
                    assert got == want
    assert torch.equal(unfragment(frag, 16, 64), w)
    assert torch.equal(tl._fragment_weight(w[:, :16]), w[:, :16])


def test_sources_declare_their_entries():
    """Without a compiler: the staged entries take the arguments ops/_cuda.py
    declares, ending in their plan and the stream, and the occupancy query
    its instance flags."""
    text = (_cuda.CSRC / "lstm_scan_staged.cu").read_text()
    tails = {"lstm_scan_fwd_unrolled": ["k", "cluster", "rows", "smem_bytes",
                                        "stream"],
             "lstm_layer_fwd": ["reverse", "cluster", "rows", "smem_bytes",
                                "stream"]}
    for name, argtypes in _cuda._SIGNATURES["lstm_scan_staged"].items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert len(names) == len(argtypes)
        assert names[-len(tails[name]):] == tails[name]
    query = re.search(r"\bint lstm_scan_staged_max_clusters\(([^)]*)\)", text)
    assert " ".join(query.group(1).split()) == (
        "int k, int out_f32, int H, int cluster, int rows, int* n")
    block = (_cuda.CSRC / "lstm_layer_block.cu").read_text()
    params = re.search(r"\bint lstm_layer_fwd_block\(([^)]*)\)", block)
    assert len(params.group(1).split(",")) == len(
        _cuda._SIGNATURES["lstm_layer_block"]["lstm_layer_fwd_block"])
    assert tl._SOURCE_OF["lstm_layer_fwd_block"] == "lstm_layer_block"
