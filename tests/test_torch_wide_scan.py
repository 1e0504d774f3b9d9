"""Kernels A and B as wide clusters (csrc/lstm_scan_wide.cu:
`lstm_scan_fwd_wide` and `lstm_scan_fwd_carry_wide`, each step's product
on warpgroup MMA (wgmma); the route of `lstm_scan_tm` without grad and of
`lstm_scan_carry_tm` where their model beats the resident cluster's) on the
CPU: the layout against the source (the shared bytes, the h buffer's index
map, the W_hh^T packing undone by its index map, and the products and the
cell's lane pairs as wgmma's descriptors and accumulators place them), the
planner (ops/lstm.py plan_wide_scan) at the model row counts over the stub
H100 occupancy of tests/torch_stream_stubs.py, its refusals, the route
between the wide and the resident cluster (plan_forward, by modelled waves
x step) and the two context managers that force one, the plan the wrappers
hand the entries (a recording fake of `_launch_kernel`), the kernel branch
(the fake launch of tests/test_torch_lstm_backward.py, which unpacks the
packed W_hh^T and runs the plain version) against the CPU branch, and both
wrappers against the JAX package's Pallas kernels in interpret mode at a
small H. No JAX model is built.

The tolerances: the layout checks are exact (the same values moved, and a
float64 product of the same bf16 operands summed in one order); the kernel
branch equals the CPU branch bit for bit (the fake computes the plain
version on the real units, which the padded units leave unchanged); against
Pallas the bf16 ones, 1e-2 absolute and relative: both sides compute the
same bf16 algorithm and differ in the order of the sums and in the
transcendental functions, and a float32 difference that crosses a bf16
rounding boundary moves h by one bf16 step (2^-8 relative) for the next
product.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from test_torch_lstm_backward import fake_launch
from torch_stream_stubs import stream_weight_rows, stub_occupancy
from torch_stream_stubs import stub_wide_occupancy, stub_wide_route
from torch_stream_stubs import wide_weight_rows

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
CPU = torch.device("cpu")
SOURCE = "lstm_scan_wide.cu"
# The layout, the ring, the products and the exchange kernels A-C share
# with the GRU's wide cluster.
SHARED = "scan_fwd_wide.cuh"
MODEL_ROWS = (18, 257, 2056, 2304)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _source_text(source=SOURCE):
    """The source and the shared header it includes."""
    return (_cuda.CSRC / source).read_text() + (_cuda.CSRC / SHARED
                                                ).read_text()


def _source_fn(name, **env):
    """The source's function `name` evaluated: its return expression with
    the casts dropped and integer division, its `const size_t` locals
    first."""
    text = _source_text()
    body = re.search(rf"\b{name}\([^)]*\) \{{(.*?)\}}", text, re.S).group(1)

    def py(expr):
        return " ".join(expr.replace("(size_t)", "").replace(
            "/", "//").split()).rstrip(";")

    for local in re.findall(r"const size_t (.*?);", body, re.S):
        for part in re.split(r",\s*(?![^()]*\))", local):
            key, expr = part.split("=", 1)
            env[key.strip()] = eval(py(expr), {}, env)
    return eval(py(body[body.rindex("return") + 6:]), {}, env)


def _source_smem(hsz, cluster, rows, resident, stages, boxes=4):
    def pair_bytes(units):
        return _source_fn("pair_bytes", U=units)

    return _source_fn("wide_smem", H=hsz, C=cluster, R=rows,
                      resident=resident, stages=stages, boxes=boxes,
                      pair_bytes=pair_bytes)


def _source_h_index(unit, row, rows):
    return _source_fn("h_index", u=unit, n=row, R=rows)


def _check_plan(plan, hsz, batch):
    hp = plan.hidden
    assert hp == tl.wide_hidden(hsz, plan.cluster) >= hsz
    assert hp % (16 * plan.cluster) == 0 and hp % 32 == 0
    assert plan.rows in tl.WIDE_ROWS
    assert plan.warpgroups == hp // plan.cluster // 16 <= 3
    assert plan.resident % 2 == 0 and plan.resident <= hp // 16
    assert (plan.stages == 0) == (plan.resident == hp // 16)
    assert plan.stages in (0, *tl.WIDE_STAGES) and min(tl.WIDE_STAGES) == 2
    assert plan.stages <= hp // 32 - plan.resident // 2 or not plan.stages
    assert plan.clusters == -(-batch // plan.rows)
    assert (plan.clusters - 1) * plan.rows < batch
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.smem_bytes == tl.wide_smem_bytes(
        hp, plan.cluster, plan.rows, plan.resident, plan.stages)
    assert plan.smem_bytes == _source_smem(hp, plan.cluster, plan.rows,
                                           plan.resident, plan.stages)
    assert plan.smem_bytes <= tl.SMEM_LIMIT and plan.smem_bytes % 8 == 0
    assert plan.step_us == tl.wide_step_us(hp, plan.cluster, plan.rows,
                                           plan.resident, plan.stages)
    assert plan.launch_args == (plan.cluster, plan.rows, plan.resident,
                                plan.stages, plan.smem_bytes)


@pytest.mark.parametrize("hsz", [128, 256, 384, 512])
def test_wide_layout_is_the_source(hsz):
    """The planner's plans at the model row counts (stub occupancy): the
    shared bytes are the source's layout (the gates, the W_hh^T ring and
    resident k-pairs, the h buffer and the mbarriers), within SMEM_LIMIT,
    for the plan and for every resident count and ring it could have."""
    for rows in MODEL_ROWS:
        plan = tl.plan_wide_scan(hsz, rows, stub_wide_occupancy)
        _check_plan(plan, hsz, rows)
        for stages in (0, 2, 3):
            top = plan.hidden // 16 - (2 if stages else 0)
            for resident in range(0 if stages else top, top + 1, 2):
                assert tl.wide_smem_bytes(
                    plan.hidden, plan.cluster, plan.rows, resident,
                    stages) == _source_smem(plan.hidden, plan.cluster,
                                            plan.rows, resident, stages)


@pytest.mark.parametrize("units,rows", [(16, 16), (32, 48), (48, 144),
                                        (48, 160)])
def test_h_layout_is_the_source(units, rows):
    """The source's h buffer [H / 8][R][8] (h_index) holds every (unit,
    row) of an h tensor once, each CTA's slice of `units` units one
    contiguous block at rank * units * rows, and the 16-byte pieces the
    bf16 output copies (8 units of a row) contiguous."""
    hsz = 8 * units
    h = torch.from_numpy(_rand((rows, hsz), units + rows)).to(torch.bfloat16)
    buf = torch.full((hsz * rows,), float("nan"), dtype=torch.bfloat16)
    u, n = torch.meshgrid(torch.arange(hsz), torch.arange(rows),
                          indexing="ij")
    index = _source_h_index(u, n, rows)
    assert torch.equal(index, ((u // 8) * rows + n) * 8 + u % 8)
    buf[index] = h.t()
    assert torch.equal(buf.view(hsz // 8, rows, 8).permute(1, 0, 2).reshape(
        rows, hsz), h)
    for rank in range(8):
        cols = index[rank * units:(rank + 1) * units]
        assert int(cols.min()) == rank * units * rows
        assert int(cols.max()) == (rank + 1) * units * rows - 1
    piece = index[8:16, rows - 1]
    assert torch.equal(piece, piece[0] + torch.arange(8))


@pytest.mark.parametrize("hsz,cluster", [(128, 8), (256, 16), (384, 8),
                                         (512, 16)])
def test_wide_weight_is_the_index_map(hsz, cluster):
    """_wide_weight, undone by the index map the source documents (row m of
    a k8 group is gate 2 hi + (r & 1) of unit 16 wg + 4 w + r // 2), is the
    kernel weight exactly, at H padded from hsz - 20 units."""
    w_hh = torch.from_numpy(_rand((hsz - 20, 4 * (hsz - 20)), hsz, 0.1))
    plan = tl.plan_wide_scan(hsz - 20, 40, stub_wide_occupancy)
    plan = dataclasses.replace(plan, hidden=tl.wide_hidden(hsz - 20, cluster),
                               cluster=cluster)
    assert plan.hidden == hsz
    wf = tl._wide_weight(w_hh, hsz, cluster)
    assert wf.dtype == torch.bfloat16 and wf.is_contiguous()
    assert torch.equal(wide_weight_rows(wf, plan),
                       tl._kernel_weight(w_hh, hsz))


def _descriptor_read(buf, start, lbo, sbo, rows):
    """The [rows x 16] K-major operand a wgmma descriptor without swizzle
    reads at byte `start` of the bf16 buffer buf: element (row, k) at start
    + (row // 8) sbo + (row % 8) 16 + (k // 8) lbo + (k % 8) 2."""
    r, k = torch.meshgrid(torch.arange(rows), torch.arange(16), indexing="ij")
    byte = start + r // 8 * sbo + r % 8 * 16 + k // 8 * lbo + k % 8 * 2
    assert int(byte.min()) >= 0 and not (byte % 2).any()
    return buf[byte // 2]


def _source_descriptors(units, rows):
    """The source's byte offsets of the products: (A's leading byte offset,
    B's, a warpgroup's offset per warpgroup, the stride byte offset)."""
    text = _source_text()
    lbo = re.search(r"m.a_lbo = (.*?);\s*m.b_lbo = (.*?);", text)
    wg = re.search(r"m.ring_a = cta_addr\(w.ring\) \+ (.*?) \* wg;", text)
    env = {"U": units, "R": rows}
    sbo = set(re.findall(r"kmajor_desc\([^;]*?_lbo,\s*(\d+)\)", text,
                         re.S))
    assert len(sbo) == 1
    return (eval(lbo.group(1), {}, env), eval(lbo.group(2), {}, env),
            eval(wg.group(1), {}, env), int(sbo.pop()))


@pytest.mark.parametrize("hsz,cluster,rows", [(128, 8, 16), (384, 8, 48),
                                              (512, 16, 32)])
def test_descriptors_and_lanes_give_each_cell_its_gates(hsz, cluster, rows):
    """One step of one CTA as wgmma's K-major descriptors (the source's
    leading and stride byte offsets) read the packed W_hh^T slice and the h
    buffer, each warpgroup's m64 x rows accumulators placed in its threads
    as wgmma places them (row lane / 4 (+ 8) of the warp's 16, columns 8i +
    2 (lane % 4) + e), and the cell's exchange between lane and lane ^ 4:
    every thread gets the four gates of its unit at its row, equal to the
    product of the real layout (float64 of the same bf16 operands)."""
    units = hsz // cluster
    a_lbo, b_lbo, a_wg, sbo = _source_descriptors(units, rows)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), hsz + rows, 0.1))
    h = torch.from_numpy(_rand((rows, hsz), rows)).to(torch.bfloat16)
    wt = tl._kernel_weight(w_hh, hsz).double()
    want = (wt @ h.double().t()).reshape(4, hsz, rows)   # [gate][unit][row]
    wf = tl._wide_weight(w_hh, hsz, cluster).double()
    u, n = torch.meshgrid(torch.arange(hsz), torch.arange(rows),
                          indexing="ij")
    hbuf = torch.empty(hsz * rows, dtype=torch.float64)
    hbuf[((u // 8) * rows + n) * 8 + u % 8] = h.t().double()
    lane = torch.arange(32)
    r8, tq = lane // 4, lane % 4
    e = r8 % 2
    for rank in range(cluster):
        pairs = wf[rank].reshape(hsz // 32, -1)          # a k-pair a row
        for wg in range(units // 16):
            acc = torch.zeros(64, rows, dtype=torch.float64)
            for k in range(hsz // 16):
                a = _descriptor_read(pairs[k // 2], a_wg * wg + k % 2 * 2
                                     * a_lbo, a_lbo, sbo, 64)
                b = _descriptor_read(hbuf, k * 2 * b_lbo, b_lbo, sbo, rows)
                acc += a @ b.t()
            for w in range(4):
                # d[4i + 2 hi + c]: row 16 w + r8 + 8 hi, column 8i + 2 tq + c
                d = acc[16 * w + r8[:, None, None, None]
                        + 8 * torch.arange(2)[None, :, None, None],
                        8 * torch.arange(rows // 8)[None, None, :, None]
                        + 2 * tq[:, None, None, None]
                        + torch.arange(2)[None, None, None, :]]
                # d: [lane][hi][i][c]; the partner sends its column 1 - e
                mine = d[lane, :, :, e]             # [lane][hi][i]
                sent = d[lane, :, :, 1 - e]
                got = sent[lane ^ 4]
                first = torch.where(e[:, None] == 1, got[:, 0], mine[:, 0])
                second = torch.where(e[:, None] == 1, mine[:, 0], got[:, 0])
                third = torch.where(e[:, None] == 1, got[:, 1], mine[:, 1])
                fourth = torch.where(e[:, None] == 1, mine[:, 1], got[:, 1])
                unit = rank * units + 16 * wg + 4 * w + r8 // 2
                row = (8 * torch.arange(rows // 8)[None, :]
                       + 2 * tq[:, None] + e[:, None])
                for gate, z in enumerate((first, second, third, fourth)):
                    assert torch.equal(z, want[gate, unit[:, None], row])


@pytest.mark.parametrize("hsz", [384, 512])
@pytest.mark.parametrize("rows", MODEL_ROWS)
def test_plans_at_the_model_rows(hsz, rows):
    """At FullSubNet+'s sub-band batches (H=384: 8 x 10 s, 2056 rows, one
    10 s request, 257, the training batch, 2304) and the full band's 18
    rows the plan is a valid layout whose modelled waves x step no plan of
    the same cluster size with the next smaller or larger row instance
    beats; at 2056 rows of H=384 one wave of 15 clusters of 8 x 144 rows,
    three warpgroups a CTA, where the resident cluster needs five; at
    H=512 clusters of 16 (two warpgroups: 32 units a CTA; at C=8 64 units
    would need four)."""
    plan = tl.plan_wide_scan(hsz, rows, stub_wide_occupancy)
    _check_plan(plan, hsz, rows)
    best = plan.waves * plan.step_us
    at = tl.WIDE_ROWS.index(plan.rows)
    for other_rows in tl.WIDE_ROWS[max(at - 1, 0):at + 2]:
        clusters = -(-rows // other_rows)
        for stages in (0, *tl.WIDE_STAGES):
            res = tl._wide_resident(plan.hidden, plan.cluster, other_rows,
                                    stages, None)
            if res is None:
                continue
            waves = -(-clusters // stub_wide_occupancy(
                plan.hidden, plan.cluster, other_rows, res, stages))
            assert best <= waves * tl.wide_step_us(
                plan.hidden, plan.cluster, other_rows, res, stages)
    if (hsz, rows) == (384, 2056):
        assert (plan.cluster, plan.rows, plan.warpgroups, plan.clusters,
                plan.waves) == (8, 144, 3, 15, 1)
        assert plan.resident < 24 and plan.stages > 0
        resident = tl.plan_scan(384, 2056, lambda c, r: stub_occupancy(
            384, c, r, 0, 1))
        assert resident.waves == 5
    if hsz == 512:
        assert plan.cluster == 16 and plan.warpgroups == 2


@pytest.mark.parametrize("rows", [257, 2047, 2304])
def test_ragged_and_training_rows_keep_a_plan(rows):
    """At 257 (one request), 2047 (a ragged batch) and 2304 rows (the
    training batch) the H=384 plan is a valid layout; 2047 and 2304 rows
    run in one wave of clusters of 8, with the fewest rows a cluster that
    give one (the stub card runs 16 such clusters at once)."""
    plan = tl.plan_wide_scan(384, rows, stub_wide_occupancy)
    _check_plan(plan, 384, rows)
    if rows > 2000:
        assert (plan.cluster, plan.waves) == (8, 1)
        assert plan.rows == min(r for r in tl.WIDE_ROWS if -(-rows // r) <= 16)


def test_refusals_name_the_bytes():
    """Above 48 units a CTA (three warpgroups) no cluster size takes H: at
    H=768 the plan is a cluster of 16, at H=1024 and 2304 the planner
    raises naming each cluster size's units and warpgroups; no card's
    cluster: the planner says so; a plan that is not the entry's WidePlan
    at the H given is refused before anything launches."""
    assert tl.plan_wide_scan(768, 18, stub_wide_occupancy).cluster == 16
    with pytest.raises(ValueError, match=r"no wide plan for the LSTM scan at "
                                         r"H=1024, 18 rows: C=8: 128 units a "
                                         r"CTA need 8 warpgroups of 16 \(at "
                                         r"most 3\); C=16: 64 units a CTA "
                                         r"need 4 warpgroups"):
        tl.plan_wide_scan(1024, 18, stub_wide_occupancy)
    with pytest.raises(ValueError, match=r"C=16: 144 units a CTA need 9 "
                                         r"warpgroups"):
        tl.plan_wide_scan(2304, 2056, stub_wide_occupancy)
    with pytest.raises(ValueError, match="at least one row"):
        tl.plan_wide_scan(384, 0, stub_wide_occupancy)
    with pytest.raises(ValueError, match="no wide plan.*the card runs no"):
        tl.plan_wide_scan(384, 18, lambda *a: 0)
    plan = tl.plan_wide_scan(384, 40, stub_wide_occupancy)
    x = torch.zeros(2, 16)
    for bad in (None, tl.plan_stream_scan(384, 40, stub_occupancy),
                tl.plan_wide_scan(512, 40, stub_wide_occupancy)):
        with pytest.raises(ValueError, match="WidePlan its weight was packed "
                                             "for, at H=384"):
            tl._launch("lstm_scan_fwd_wide", x, x, x, 0, 5, 40, 384, 0,
                       plan=bad)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_launch_kernel", lambda *a: seen.append(a))
        tl._launch("lstm_scan_fwd_wide", x, x, x, 0, 5, 40, 384, 0, plan=plan)
    assert seen == [("lstm_scan_fwd_wide", x, x, x, 0, 5, 40, 384, 0,
                     *plan.launch_args)]


def test_sources_declare_their_entries():
    """Without a compiler: the three entries and the traced one take the
    arguments ops/_cuda.py declares, ending in their plan and the stream,
    the occupancy query its plan's ring, the instances are WIDE_ROWS and
    their products wgmma, the entries refuse bytes that are not the
    layout's, and the launch counts know the three entries."""
    text = _source_text()
    tail = ["reverse", "cluster", "rows", "resident", "stages", "smem_bytes",
            "stream"]
    sigs = _cuda._SIGNATURES["lstm_scan_wide"]
    assert set(sigs) == {*tl._WIDE_ENTRIES, "lstm_scan_wide_trace"}
    for name, argtypes in sigs.items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert len(names) == len(argtypes)
        if name == "lstm_scan_wide_trace":
            assert names[-8:] == [*tail[:-1], "trace", "stream"]
            continue
        assert names[-len(tail):] == tail
        assert tl._SOURCE_OF[name] == "lstm_scan_wide"
        assert name in tl.launch_counts
    query = re.search(r"\bint lstm_scan_wide_max_clusters\(([^)]*)\)", text)
    assert " ".join(query.group(1).split()) == (
        "int resident, int stages, int H, int cluster, int rows, int* n")
    assert len(_cuda._QUERIES["lstm_scan_wide"][
        "lstm_scan_wide_max_clusters"]) == 6
    instances = re.search(r"#define WIDE_INSTANCES\(X\)(.*?)\n\n", text, re.S)
    assert tuple(int(n) for n in re.findall(r"X\((\d+)\)",
                                            instances.group(1))) \
        == tl.WIDE_ROWS
    for rows in tl.WIDE_ROWS:
        assert (f"wgmma.mma_async.sync.aligned.m64n{rows}k16.f32.bf16.bf16"
                in text)
    assert "WIDE_MAX_WG = 3;" in text and tl._WIDE_MAX_WARPGROUPS == 3
    assert "(stages == 0 || stages >= 2)" in text
    assert "smem_bytes != wide_smem(H, C, R, resident, stages, 4)" in text
    assert "lstm_scan_wide" in _cuda.SOURCES


def test_step_model():
    """The wide step grows with the rows (the products and the cell) and
    with the units a CTA; the streamed k-pairs cost no less than the
    resident ones."""
    base = tl.wide_step_us(384, 8, 144, 0, 3)
    assert tl.wide_step_us(384, 8, 96, 0, 3) < base
    assert tl.wide_step_us(384, 8, 144, 2, 3) <= base
    assert tl.wide_step_us(384, 8, 48, 24, 0) < tl.wide_step_us(
        384, 8, 48, 22, 1)
    assert tl.wide_step_us(256, 8, 48, 16, 0) < tl.wide_step_us(
        384, 8, 48, 24, 0)


def _modelled_resident(hsz, rows):
    plan = tl.plan_scan(hsz, rows, lambda c, r: stub_occupancy(hsz, c, r, 0,
                                                               1))
    return plan.waves * tl.scan_step_us(hsz, plan.cluster, plan.rows)


@pytest.mark.parametrize("hsz", [384, 512])
def test_route_weighs_wide_against_resident(hsz, monkeypatch):
    """On a card (stubbed) kernels A, B and C take the wide cluster where
    its modelled waves x step beat the resident cluster's, at every row
    count, for each output type (kernel C's layout is kernel A's, so its
    wide plan is theirs); on CPU tensors, with no occupancy to weigh, the
    resident cluster."""
    assert tl._forward_route(hsz, 2056, CPU) == (hsz, "", None)
    stub_wide_route(monkeypatch)
    for rows in MODEL_ROWS + (1, 2047):
        wide = tl.plan_wide_scan(hsz, rows, stub_wide_occupancy)
        faster = wide.waves * wide.step_us < _modelled_resident(hsz, rows)
        for instance in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                         (0, 0, 1)):
            got = tl._forward_route(hsz, rows, CPU, instance)
            assert got == ((wide.hidden, "_wide", wide) if faster
                           else (hsz, "", None)), (rows, instance)
    assert tl._forward_route(384, 2056, CPU)[1] == "_wide"


def test_context_managers_force_their_route(monkeypatch):
    """wide_forwards() forces the wide cluster for kernels A, B and C at
    any row count (and on CPU tensors), resident_forwards() the resident
    cluster; the GRU forwards follow them to their own wide cluster (a plan
    of three gates), neither moves kernels E and F, and
    single_block_forwards() / streamed_forwards() still win."""
    stub_wide_route(monkeypatch)
    monkeypatch.setattr(
        tg, "card_gru_wide_plan", lambda device, hsz, batch, resident=None:
        tg.plan_gru_wide_scan(hsz, batch, stub_wide_occupancy, resident))
    with tl.resident_forwards():
        assert tl._forward_route(384, 2056, CPU) == (384, "", None)
        with tl.wide_forwards():
            assert tl._forward_route(384, 2056, CPU)[1] == "_wide"
        assert tl._forward_route(384, 2056, CPU)[1] == ""
    monkeypatch.setattr(tl, "_on_card", lambda device: False)
    with tl.wide_forwards():
        for rows in (1, 18, 2056):
            hp, suffix, plan = tl._forward_route(384, rows, CPU, (1, 1, 0))
            assert suffix == "_wide" and plan == tl.plan_wide_scan(
                384, rows, stub_wide_occupancy)
        assert tl._forward_route(384, 18, CPU, (0, 0, 1)) == (
            384, "_wide", tl.plan_wide_scan(384, 18, stub_wide_occupancy))
        assert tg._forward_route(384, 18, CPU) == (
            384, "_wide", tg.plan_gru_wide_scan(384, 18, stub_wide_occupancy))
        assert tl.layer_route(384, 34, 18, CPU) == (384, "", None)
        assert tl.unrolled_route(384, 2, 18, CPU) == (384, "", None)
        with tl.single_block_forwards():
            assert tl._forward_route(384, 18, CPU)[1] == "_block"
    assert tl._forward_route(384, 2056, CPU) == (384, "", None)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wrappers_hand_the_entries_their_plan(carry, out_dtype, monkeypatch):
    """lstm_scan_tm and lstm_scan_carry_tm on a (stubbed) card at 2056 rows
    of H=384: one launch of the wide entry, whose arguments are the
    wrapper's operands (W_hh^T packed for wgmma for the plan's cluster) and
    end in the plan card_wide_plan gave (one instance for both entries and
    both output types)."""
    stub_wide_route(monkeypatch)
    asked = []
    monkeypatch.setattr(
        tl, "card_wide_plan",
        lambda device, hsz, batch, resident=None:
        asked.append((hsz, batch)) or tl.plan_wide_scan(hsz, batch,
                                                        stub_wide_occupancy))
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    calls = []
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    t_len, b, hsz = 2, 2056, 384
    gates = torch.zeros(t_len, b, 4 * hsz, dtype=torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), 5, 0.05))
    state = torch.zeros(b, hsz)
    with torch.no_grad():
        if carry:
            tl.lstm_scan_carry_tm(gates, w_hh, state, state, True, out_dtype)
        else:
            tl.lstm_scan_tm(gates, w_hh, True, out_dtype)
    plan = tl.plan_wide_scan(hsz, b, stub_wide_occupancy)
    f32 = int(out_dtype == torch.float32)
    assert asked and set(asked) == {(hsz, b)}
    (name, args), = calls
    assert name == ("lstm_scan_fwd_carry_wide" if carry
                    else "lstm_scan_fwd_wide")
    assert args[-10:] == (f32, t_len, b, hsz, True, *plan.launch_args)
    assert args[0] is gates
    assert torch.equal(wide_weight_rows(args[1], plan),
                       tl._kernel_weight(w_hh))
    n_out = 3 if carry else 1
    outs = args[-10 - n_out:-10]
    assert outs[0].shape == (t_len, b, hsz) and outs[0].dtype == out_dtype
    if carry:
        assert args[2] is state and args[3] is state
        assert all(o.shape == (b, hsz) and o.dtype == torch.float32
                   for o in outs[1:])


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fake launch
    of tests/test_torch_lstm_backward.py and the route weighing the stub
    plans as on a card."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_wide_route(monkeypatch)
    return tl.launch_counts


def _counted(counts, expected, fn):
    for name in counts:
        counts[name] = 0
    out = fn()
    assert counts == {**dict.fromkeys(counts, 0), **expected}, counts
    return out


def _on_cpu(fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        return fn()


def _chunked(gates, w_hh, h0, c0, reverse, out_dtype, t_chunk):
    """lstm_scan_carry_tm over chunks of t_chunk steps, the carry handed on
    (from the later chunk when reversed)."""
    t_len = gates.shape[0]
    starts = list(range(0, t_len, t_chunk))
    out = torch.empty(t_len, gates.shape[1], w_hh.shape[0], dtype=out_dtype)
    h, c = h0, c0
    for s in (starts[::-1] if reverse else starts):
        e = min(s + t_chunk, t_len)
        out[s:e], h, c = tl.lstm_scan_carry_tm(gates[s:e], w_hh, h, c,
                                               reverse, out_dtype)
    return out, h, c


@pytest.mark.parametrize("hsz", [100, 128])
def test_kernel_branch_equals_the_cpu_branch(launches, hsz):
    """At H=100 (padded to the wide cluster's units) and 128 over 40 rows
    under wide_forwards(): one lstm_scan_fwd_wide a call and one
    lstm_scan_fwd_carry_wide a chunk, forward and reverse, bf16 and fp32
    out, equal to the CPU branch; the chunked carry equals the unchunked
    forward and the carry's state the CPU branch's."""
    gates = torch.from_numpy(_rand((9, 40, 4 * hsz), hsz)).to(torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), hsz + 1, 0.1))
    h0 = torch.from_numpy(_rand((40, hsz), hsz + 2))
    c0 = torch.from_numpy(_rand((40, hsz), hsz + 3))
    zero = torch.zeros(40, hsz)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            with torch.no_grad(), tl.wide_forwards():
                got = _counted(launches, {"lstm_scan_fwd_wide": 1},
                               lambda: tl.lstm_scan_tm(gates, w_hh, reverse,
                                                       out_dtype))
                chunks = _counted(
                    launches, {"lstm_scan_fwd_carry_wide": 3},
                    lambda: _chunked(gates, w_hh, zero, zero, reverse,
                                     out_dtype, 4))
                state = _counted(
                    launches, {"lstm_scan_fwd_carry_wide": 1},
                    lambda: tl.lstm_scan_carry_tm(gates, w_hh, h0, c0,
                                                  reverse, out_dtype))
            want = _on_cpu(lambda: tl.lstm_scan_tm(gates, w_hh, reverse,
                                                   out_dtype))
            assert got.dtype == out_dtype and torch.equal(got, want)
            assert torch.equal(chunks[0], want)
            want_state = _on_cpu(lambda: tl.lstm_scan_carry_tm(
                gates, w_hh, h0, c0, reverse, out_dtype))
            for a, b in zip(state, want_state):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
def test_forward_matches_pallas_interpret(launches, reverse):
    """lstm_scan_tm on the wide branch (the route at 2056 rows is not
    needed: wide_forwards()) at H=128 x 40 rows x T=12 against the JAX
    lstm_scan_tm with its Pallas kernel in interpret mode, fp32 out."""
    hsz = 128
    gx, whh = _rand((12, 40, 4 * hsz), 21), _rand((hsz, 4 * hsz), 22, 0.08)
    want = np.asarray(jl.lstm_scan_tm(gx, whh, reverse, 576, True,
                                      jnp.float32))
    with torch.no_grad(), tl.wide_forwards():
        got = _counted(launches, {"lstm_scan_fwd_wide": 1},
                       lambda: tl.lstm_scan_tm(torch.from_numpy(gx),
                                               torch.from_numpy(whh), reverse,
                                               torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **BF16)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_carry_matches_pallas_interpret(launches, reverse):
    """lstm_scan_carry_tm on the wide branch over chunks of 4 of T=12 at
    H=96 (padded to 128) x 40 rows from a random state, against the JAX package's carry
    kernel (_lstm_pallas_call_carry) in interpret mode chained the same
    way: h sequence, h_T and c_T, fp32 out."""
    hsz, b, t_len, t_chunk = 96, 40, 12, 4
    gx = _rand((t_len, b, 4 * hsz), 31)
    whh = _rand((hsz, 4 * hsz), 32, 0.1)
    h0, c0 = _rand((b, hsz), 33), _rand((b, hsz), 34)
    gates = jnp.asarray(gx, jnp.bfloat16)
    starts = list(range(0, t_len, t_chunk))
    want_seq, h, c = [None] * len(starts), jnp.asarray(h0), jnp.asarray(c0)
    for i in (range(len(starts))[::-1] if reverse else range(len(starts))):
        s = starts[i]
        want_seq[i], h, c = jl._lstm_pallas_call_carry(
            gates[s:s + t_chunk], h, c, jnp.asarray(whh), block_b=b,
            interpret=True, out_dtype=jnp.float32, reverse=reverse)
    want = np.concatenate([np.asarray(x) for x in want_seq])
    tgates = torch.from_numpy(np.array(gates.astype(jnp.float32))
                              ).to(torch.bfloat16)
    with torch.no_grad(), tl.wide_forwards():
        got, h_t, c_t = _counted(
            launches, {"lstm_scan_fwd_carry_wide": 3},
            lambda: _chunked(tgates, torch.from_numpy(whh),
                             torch.from_numpy(h0), torch.from_numpy(c0),
                             reverse, torch.float32, t_chunk))
    np.testing.assert_allclose(got.numpy(), want, **BF16)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h), **BF16)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c), **BF16)


def test_route_takes_wide_on_the_kernel_branch(launches):
    """Without a context manager, the kernel branch at 2056 rows of H=384
    launches the wide entry (the route on the stubbed card), at 18 rows
    whichever design models faster, each equal to the CPU branch."""
    w_hh = torch.from_numpy(_rand((384, 1536), 41, 0.05))
    for rows in (2056, 18):
        gates = torch.from_numpy(_rand((2, rows, 1536), 40 + rows)).to(
            torch.bfloat16)
        entry = "lstm_scan_fwd" + tl._forward_route(384, rows, CPU)[1]
        with torch.no_grad():
            got = _counted(launches, {entry: 1},
                           lambda: tl.lstm_scan_tm(gates, w_hh))
        assert torch.equal(got, _on_cpu(lambda: tl.lstm_scan_tm(gates,
                                                                w_hh)))
    assert tl._forward_route(384, 2056, CPU)[1] == "_wide"
