"""The launch plans of the two backward scans and the single-block forward
route, on the CPU (no JAX, no card).

ops.lstm.plan_bwd_scan and ops.gru.plan_bwd_scan weigh the single-block
design (csrc/lstm_scan_bwd.cu, csrc/gru_scan_bwd.cu, 16 rows a block) against
thread-block clusters from the shared memory of each layout, the card's
occupancy (faked here as an H100 SXM gives it: 15 clusters of 8 or 7 of 16
for one CTA an SM) and a step model fitted on the card. Both designs give
the same bits, so the plan moves only the time. The wrappers hand the plan
to the entry they launch; a forward scan at an H that no cluster holds
takes the single-block entries (csrc/lstm_scan_block.cu,
csrc/gru_scan_block.cu).
"""
import re

import numpy as np
import pytest
import torch

from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from torch_stream_stubs import stub_stream_plans

torch.set_num_threads(2)
KINDS = {"lstm": (tl, 4, "lstm_scan_bwd.cu"), "gru": (tg, 3, "gru_scan_bwd.cu")}


def h100_clusters(cluster, rows, resident=False):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM."""
    return 15 if cluster == 8 else 7


def _c_function(source, signature):
    """The body of a small C function of csrc/<source> as a Python
    expression: the ternaries, casts and integer divisions rewritten."""
    text = (_cuda.CSRC / source).read_text()
    body = re.search(re.escape(signature) + r"\s*\{(.*?)\n\}", text,
                     re.S).group(1)
    expr = " ".join(body[body.rindex("return") + len("return"):].split())
    expr = expr.rstrip(";")
    expr = re.sub(r"\(size_t\)|sizeof\(__nv_bfloat16\)", lambda m:
                  "" if m.group(0) == "(size_t)" else "2", expr)
    expr = expr.replace("sizeof(float)", "4").replace("/", "//")
    expr = re.sub(r"\(([^()?]+?) \? ([^()]+?) : ([^()]+?)\)",
                  r"((\2) if (\1) else (\3))", expr)
    return expr


def _source_cluster_smem(kind, hsz, cluster, rows, resident):
    """bwd_cluster_smem of the kernel's source, evaluated."""
    _, _, source = KINDS[kind]
    stride = _c_function(source, "__host__ __device__ inline int "
                                 "slice_stride(int U)")
    smem = _c_function(source, "size_t bwd_cluster_smem(int H, int C, int R, "
                               "bool resident)")
    units = hsz // cluster
    n = 4 if kind == "lstm" else 3
    env = dict(U=units, hs=hsz + 8, gs=n * hsz + 8, r=rows, R=rows, C=cluster,
               H=hsz, resident=resident, PAD=8, ROWS=16)
    env["slice_stride"] = lambda u: eval(stride, {}, dict(U=u))
    return eval(smem, {}, env)


# the layouts of both W_hh slices resident or one streamed (H=384 and 512),
# and the plans the sweep ran
LAYOUTS = [(384, 16, 16, True), (512, 16, 16, True), (384, 16, 32, True),
           (384, 8, 16, False), (512, 8, 16, False), (384, 16, 16, False),
           (512, 16, 16, False), (384, 16, 32, False), (384, 16, 48, False)]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hsz,cluster,rows,resident", LAYOUTS)
def test_cluster_smem_is_the_source_layout(kind, hsz, cluster, rows,
                                           resident):
    module, _, _ = KINDS[kind]
    got = module.bwd_smem_bytes_cluster(hsz, cluster, rows, resident)
    assert got == _source_cluster_smem(kind, hsz, cluster, rows, resident)
    assert got % 16 == 0


def test_which_layouts_fit():
    """Where the dgates tile, the W_hh slices and the recompute's hand-over
    fit 227 KB: the recompute's W_hh^T slice stays in shared memory only at
    C=16 x 16 rows (H=384) and is streamed elsewhere; at H=512 only C=16 x
    16 streamed fits (the full band's two clusters), for both kernels."""
    fits = {(kind, *layout) for kind in KINDS for layout in LAYOUTS
            if KINDS[kind][0].bwd_smem_bytes_cluster(*layout) <= tl.SMEM_LIMIT}
    both = {(384, 16, 16, True), (384, 8, 16, False), (384, 16, 16, False),
            (512, 16, 16, False), (384, 16, 32, False)}
    assert {layout[1:] for layout in fits if layout[0] == "lstm"} == both
    assert {layout[1:] for layout in fits if layout[0] == "gru"} == both


@pytest.mark.parametrize("hsz", [16, 384, 512, 768])
def test_block_smem_is_the_source_layout(hsz):
    lstm = _c_function("lstm_scan_bwd.cu", "size_t block_smem(int H)")
    gru = _c_function("gru_scan_bwd.cu", "size_t block_smem(int H)")
    env = dict(H=hsz, ROWS=16, PAD=8)
    assert tl.bwd_smem_bytes(hsz) == eval(lstm, {}, env)
    assert tg.bwd_block_smem_bytes(hsz) == eval(gru, {}, env)
    # kernel D's single block with dc in registers: 111 104 B at H=384
    # before, with dc in shared memory too
    assert tl.bwd_smem_bytes(384) == 86528


# (H, rows) -> (C, R, resident, clusters) at the four model shapes
MODEL_PLANS = {(384, 2304): (8, 16, False, 144), (384, 2295): (8, 16, False, 144),
               (512, 18): (16, 16, False, 2), (512, 1): (16, 16, False, 1)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hsz,batch", sorted(MODEL_PLANS))
def test_plan_at_the_model_shapes(kind, hsz, batch):
    """The resident cluster's plans (for kernel D within
    resident_backwards(): its wide cluster, the route at the sub-band
    batch, has tests of its own in tests/test_torch_wide_bwd.py)."""
    module, n_gates, _ = KINDS[kind]
    with tl.resident_backwards():
        plan = module.plan_bwd_scan(hsz, batch, h100_clusters)
    assert plan.design == "cluster"
    assert (plan.cluster, plan.rows, plan.resident, plan.clusters) == \
        MODEL_PLANS[hsz, batch]
    assert hsz % (8 * plan.cluster) == 0 and plan.rows % 16 == 0
    assert 2 * plan.rows // 16 * hsz // plan.cluster // 8 <= tl.BWD_WARPS
    assert plan.smem_bytes == module.bwd_smem_bytes_cluster(
        hsz, plan.cluster, plan.rows, plan.resident) <= tl.SMEM_LIMIT
    assert plan.clusters * plan.rows >= batch
    assert plan.active == h100_clusters(plan.cluster, plan.rows)
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.step_us == module.bwd_step_us(hsz, plan.cluster, plan.rows,
                                              plan.resident)
    assert plan.launch_args == (plan.cluster, plan.rows, int(plan.resident),
                                plan.smem_bytes)
    # the single block would take longer by the model
    block = module.plan_bwd_scan(hsz, batch, lambda c, r, res: 0)
    assert block.design == "block" and block.cluster == 1 and block.rows == 16
    assert block.waves * block.step_us > plan.waves * plan.step_us


# one-cluster steps (us) measured on an H100 SXM at 700 W, T=195
# (generative_audio_torch/scripts/perf_bwd_scan.py): (H, C, R, resident)
MEASURED_STEPS = {
    "lstm": {(384, 8, 16, False): 8.49, (384, 16, 16, True): 6.74,
             (384, 16, 16, False): 7.48, (384, 16, 32, False): 10.83,
             (512, 16, 16, False): 9.06},
    "gru": {(384, 8, 16, False): 6.61, (384, 16, 16, True): 5.74,
            (384, 16, 16, False): 6.03, (384, 16, 32, False): 8.11,
            (512, 16, 16, False): 7.33}}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_step_model_fits_the_sweep(kind):
    module = KINDS[kind][0]
    for layout, us in MEASURED_STEPS[kind].items():
        assert module.bwd_step_us(*layout) == pytest.approx(us, abs=0.05)


@pytest.mark.parametrize("kind,hsz", [("lstm", 768), ("gru", 768),
                                      ("gru", 1024), ("lstm", 112)])
def test_single_block_where_no_cluster_fits(kind, hsz):
    """At an H that no resident cluster takes (no multiple of 64, or no
    cluster's slices fit) the plan is the single-block design, padded H and
    all, up to H=512; above, where the single block held H alone before,
    the streamed cluster (csrc/scan_bwd_stream.cu), whose modelled waves x
    step beat the single block's at 40 rows, and the single block again
    where the card runs no streamed cluster."""
    module = KINDS[kind][0]
    plan = module.plan_bwd_scan(hsz, 40, h100_clusters)
    block = module.plan_bwd_scan(hsz, 40, h100_clusters,
                                 stream_clusters=lambda *a: 0)
    assert block.design == "block" and block.clusters == 3
    assert block.launch_args == (1, 16, 0, block.smem_bytes)
    if hsz <= 512:
        assert plan == block
    else:
        assert plan.design == "stream" and plan.hidden >= hsz
        assert plan.waves * plan.step_us < block.waves * block.step_us


def test_lstm_block_limit_is_the_parent_s():
    """Kernel D's single block needed 295 424 B at H=1024 while it kept dc
    in shared memory; with dc in registers it needs 229 888 B and runs.
    Above that (H=1040) its shared memory refuses, as the parent's did above
    784, and the streamed cluster takes H (up to 2304, the forwards'
    limit); above 2304 nothing does."""
    assert tl.bwd_smem_bytes(1024) == 229888 <= tl.SMEM_LIMIT
    plan = tl.plan_bwd_scan(1024, 40, h100_clusters,
                            stream_clusters=lambda *a: 0)
    assert plan.design == "block" and plan.smem_bytes == 229888
    assert tl.bwd_smem_bytes(1040) == 233472 > tl.SMEM_LIMIT
    plan = tl.plan_bwd_scan(1040, 40, h100_clusters)
    assert plan.design == "stream" and plan.hidden >= 1040
    with pytest.raises(ValueError, match="no plan for the LSTM backward"):
        tl.plan_bwd_scan(1040, 40, h100_clusters,
                         stream_clusters=lambda *a: 0)
    with pytest.raises(ValueError, match="no plan for the LSTM backward"):
        tl.plan_bwd_scan(2320, 40, h100_clusters)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_single_block_at_zero_occupancy(kind):
    module = KINDS[kind][0]
    plan = module.plan_bwd_scan(384, 2304, lambda c, r, res: 0)
    assert plan.design == "block" and plan.clusters == 144
    assert plan.active == tl.sm_blocks(plan.smem_bytes) == 264


def _lstm_operands(t, b, h, seed):
    rng = np.random.default_rng(seed)

    def bf16(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(torch.bfloat16)

    return (bf16((t, b, 4 * h), 1.0), bf16((t, b, h), 0.5),
            bf16((t, b, h), 0.5), bf16((t, b, h), 1.0),
            torch.from_numpy((rng.standard_normal((h, 4 * h)) * 0.1).astype(
                np.float32)))


def _gru_operands(t, b, h, seed):
    gates, h_seq, _, gout, _ = _lstm_operands(t, b, h, seed)
    rng = np.random.default_rng(seed + 1)
    return (gates[..., :3 * h].contiguous(), h_seq, gout,
            torch.from_numpy((rng.standard_normal((h, 3 * h)) * 0.1).astype(
                np.float32)),
            torch.from_numpy((rng.standard_normal(3 * h) * 0.1).astype(
                np.float32)))


@pytest.fixture
def entries(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch faked:
    records (entry, arguments) and launches nothing."""
    calls = []
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    record = lambda name, *args: calls.append((name, args))  # noqa: E731
    monkeypatch.setattr(tl, "_launch_kernel", record)
    monkeypatch.setattr(tg, "_launch_entry", record)
    return calls


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wrappers_hand_the_card_plan_to_the_entry(kind, entries,
                                                  monkeypatch):
    module = KINDS[kind][0]
    asked = []

    def card_plan(device, hsz, batch):
        asked.append((hsz, batch))
        return module.plan_bwd_scan(hsz, batch, h100_clusters)

    monkeypatch.setattr(module, "card_bwd_scan_plan", card_plan)
    if kind == "lstm":
        tl.lstm_scan_bwd_tm(*_lstm_operands(3, 40, 64, seed=1), reverse=True)
    else:
        tg.gru_scan_bwd_streams_tm(*_gru_operands(3, 40, 64, seed=2))
    plan = module.plan_bwd_scan(64, 40, h100_clusters)
    assert asked == [(64, 40)]
    (name, args), = entries
    assert name == f"{kind}_scan_bwd"
    assert args[-8:] == (3, 40, 64, int(kind == "lstm"), *plan.launch_args)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("design", ["block", "cluster"])
def test_planned_wrappers_launch_the_given_plan(kind, design, entries,
                                                monkeypatch):
    """The A/B entry points launch the plan they are given, through the same
    entry and launch count as the wrappers; the GRU's returns the per-tile
    db_hh partials unsummed."""
    module = KINDS[kind][0]
    monkeypatch.setattr(module, "card_bwd_scan_plan", None)   # not asked
    occupancy = h100_clusters if design == "cluster" else (
        lambda c, r, res: 0)
    plan = module.plan_bwd_scan(128, 40, occupancy)
    assert plan.design == design
    if kind == "lstm":
        out = tl.lstm_scan_bwd_planned_tm(*_lstm_operands(3, 40, 128, seed=3),
                                          plan)
        assert out.shape == (3, 40, 512)
    else:
        dgx, dhn, db = tg.gru_scan_bwd_streams_planned_tm(
            *_gru_operands(3, 40, 128, seed=4), plan)
        assert db.shape == (3, 384)                # one row a 16-row tile
    (name, args), = entries
    assert name == f"{kind}_scan_bwd" and args[-4:] == plan.launch_args


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_planned_wrappers_refuse_cpu_tensors(kind):
    module = KINDS[kind][0]
    plan = module.plan_bwd_scan(64, 8, h100_clusters)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kind == "lstm":
            tl.lstm_scan_bwd_planned_tm(*_lstm_operands(2, 8, 64, seed=5),
                                        plan)
        else:
            tg.gru_scan_bwd_streams_planned_tm(
                *_gru_operands(2, 8, 64, seed=6), plan)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_branch_is_the_plain_version(kind):
    """On CPU tensors the wrappers run the plain version, plan or none."""
    if kind == "lstm":
        ops = _lstm_operands(4, 5, 32, seed=7)
        assert torch.equal(tl.lstm_scan_bwd_tm(*ops, reverse=True),
                           tl.lstm_scan_bwd_reference_tm(*ops, reverse=True))
    else:
        ops = _gru_operands(4, 5, 32, seed=8)
        for got, want in zip(tg.gru_scan_bwd_streams_tm(*ops),
                             tg.gru_scan_bwd_streams_reference_tm(*ops)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("module,hsz,route", [
    (tl, 384, (384, "")), (tl, 512, (512, "")), (tl, 640, (640, "_stream")),
    (tl, 768, (768, "_stream")), (tl, 1000, (1024, "_stream")),
    (tg, 640, (640, "")), (tg, 768, (768, "_stream")),
    (tg, 1024, (1024, "_stream"))])
def test_forward_route_by_hidden_size(module, hsz, route, monkeypatch):
    """The forwards take the resident cluster up to H=512 (LSTM) and 640
    (GRU) and above the streamed cluster (at H padded to its units), whose
    modelled time at 18 rows beats the single block's; within
    single_block_forwards() the single block at H padded to 16."""
    stub_stream_plans(monkeypatch)
    cpu = torch.device("cpu")
    hp, suffix, plan = module._forward_route(hsz, 18, cpu)
    assert (hp, suffix) == route
    assert (plan is None) == (suffix == "") and (not plan or plan.hidden == hp)
    with tl.single_block_forwards():
        assert module._forward_route(hsz, 18, cpu) == (
            -(-hsz // 16) * 16, "_block", None)


@pytest.mark.parametrize("module,source,hsz", [
    (tl, "lstm_scan_block.cu", 640), (tl, "lstm_scan_block.cu", 1024),
    (tg, "gru_scan_block.cu", 768), (tg, "gru_scan_block.cu", 1024)])
def test_block_forward_smem_is_the_source(module, source, hsz):
    text = (_cuda.CSRC / source).read_text()
    expr = re.search(r"const size_t smem = (.*?);", text, re.S).group(1)
    expr = " ".join(expr.split()).replace("sizeof(__nv_bfloat16)", "2")
    expr = expr.replace("sizeof(float)", "4")
    assert module.block_smem_bytes(hsz) == eval(expr, {}, dict(
        ROWS=16, H=hsz, PAD=8)) <= tl.SMEM_LIMIT


def test_block_sources_declare_their_entries():
    """The single-block forwards' C entries take what ops/_cuda.py declares:
    the cluster entries' arguments without the plan."""
    for source in ("lstm_scan_block", "gru_scan_block"):
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        for name, argtypes in _cuda._SIGNATURES[source].items():
            params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
            assert len(params.split(",")) == len(argtypes), name
            cluster = _cuda._SIGNATURES[source.replace("_block", "")][
                name[:-len("_block")]]
            assert argtypes == cluster[:-4] + cluster[-1:]
        assert f"{source}_error_string" in text


def test_single_block_forwards_switch_the_route(entries):
    """Within single_block_forwards() every forward wrapper launches its
    single-block entry, at H padded to 16 (no plan appended); after it, the
    route is the cluster's again."""
    gates, _, _, _, w_hh = _lstm_operands(2, 3, 24, seed=9)
    h0 = torch.zeros(3, 24)
    gx, _, _, w_g, b_g = _gru_operands(2, 3, 24, seed=10)
    with tl.single_block_forwards():
        with torch.no_grad():
            tl.lstm_scan_tm(gates, w_hh)
            tl.lstm_scan_carry_tm(gates, w_hh, h0, h0)
            tg.gru_scan_tm(gx, w_g, b_g)
            tg.gru_scan_carry_tm(gx, w_g, b_g, h0)
        tl.lstm_scan_train_tm(gates, w_hh)
    assert [name for name, _ in entries] == [
        "lstm_scan_fwd_block", "lstm_scan_fwd_carry_block",
        "gru_scan_fwd_block", "gru_scan_fwd_carry_block",
        "lstm_scan_fwd_train_block"]
    for name, args in entries:            # ..., T, B, H = 32, reverse
        assert args[-3:] == (3, 32, 0)
    assert tl._forward_route(24, 3, torch.device("cpu")) == (64, "", None)
