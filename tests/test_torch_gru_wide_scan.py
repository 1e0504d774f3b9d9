"""The GRU forward and carry as wide clusters (csrc/gru_scan_wide.cu:
`gru_scan_fwd_wide` and `gru_scan_fwd_carry_wide`, kernel A's wide design
of csrc/lstm_scan_wide.cu with the GRU cell, each step's product on
warpgroup MMA with a fourth gate row of zeros a unit; the route of
`gru_scan_tm`, `gru_scan_carry_tm`, GRUScan's forward and
`gru_layer_tm_chunked` where their model beats the resident cluster's) on
the CPU: the layout against the source (the shared bytes with three gate
boxes, the instances, the entries' arguments), the W_hh^T packing undone by
its index map with its zero rows, one step's products and the cell's lane
pairs as wgmma's descriptors and accumulators place them (each cell gets
r, z, n and b_hh of its own unit), the planner (ops/gru.py
plan_gru_wide_scan) at the v1 model's row counts over the card's stub
occupancy of tests/torch_stream_stubs.py, the route between the wide and
the resident cluster and the two context managers that force one, the plan
each wrapper hands the entries (a recording fake of `_launch_kernel`), the
kernel branch (the fake launch of tests/test_torch_gru.py, which unpacks
the packed W_hh^T and runs the plain version) against the CPU branch, and
the forward and the chunked carry against the JAX package's Pallas kernels
in interpret mode at a small H. No JAX model is built.

The tolerances: the layout checks are exact (the same values moved, and a
float64 product of the same bf16 operands summed in one order); the kernel
branch equals the CPU branch bit for bit (the fake computes the plain
version on the real units, which the padded units leave unchanged);
against Pallas, h within 5e-3 absolute, as tests/test_torch_gru.py holds
the plain version: both sides compute the same bf16 algorithm and differ in
the order of the sums and in the transcendental functions.
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
from test_torch_gru import fake_launch
from test_torch_wide_scan import (SHARED, _descriptor_read,
                                  _source_descriptors, _source_smem)
from torch_stream_stubs import (card_wide_occupancy, stub_occupancy,
                                stub_stream_plans, wide_weight_rows)

torch.set_num_threads(2)
H_ATOL = 5e-3
CPU = torch.device("cpu")
SOURCE = "gru_scan_wide.cu"
ENTRIES = ("gru_scan_fwd_wide", "gru_scan_fwd_carry_wide")
# FullSubNet v1-GRU's rows: the sub-band GRU (H=384) over the 8 x 10 s
# batch, a ragged batch, one 10 s request, the training batch and 1024
# rows; the full band (H=512) over 18 and 8 clips.
MODEL_ROWS = ((384, 2056), (384, 2047), (384, 257), (384, 2304),
              (384, 1024), (512, 18), (512, 8))


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _text():
    return (_cuda.CSRC / SOURCE).read_text()


def _plan(hsz, rows, occupancy=card_wide_occupancy):
    return tg.plan_gru_wide_scan(hsz, rows, occupancy)


def _check_gru_plan(plan, hsz, rows):
    """A valid wide layout of three gates (kernel A's checks with the GRU's
    bytes, three gate boxes, and step model) and the source's bytes."""
    hp = plan.hidden
    assert plan.gates == 3
    assert hp == tl.wide_hidden(hsz, plan.cluster) >= hsz
    assert hp % (16 * plan.cluster) == 0 and hp % 32 == 0
    assert plan.rows in tl.WIDE_ROWS
    assert plan.warpgroups == hp // plan.cluster // 16 <= 3
    assert plan.resident % 2 == 0 and plan.resident <= hp // 16
    assert (plan.stages == 0) == (plan.resident == hp // 16)
    assert plan.stages in (0, *tl.WIDE_STAGES)
    assert plan.stages <= hp // 32 - plan.resident // 2 or not plan.stages
    assert plan.clusters == -(-rows // plan.rows)
    assert (plan.clusters - 1) * plan.rows < rows
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.launch_args == (plan.cluster, plan.rows, plan.resident,
                                plan.stages, plan.smem_bytes)
    assert plan.smem_bytes == tg.gru_wide_smem_bytes(
        plan.hidden, plan.cluster, plan.rows, plan.resident, plan.stages)
    assert plan.smem_bytes == _source_smem(plan.hidden, plan.cluster,
                                           plan.rows, plan.resident,
                                           plan.stages, boxes=3)
    assert plan.smem_bytes <= tl.SMEM_LIMIT
    assert plan.step_us == tg.gru_wide_step_us(
        plan.hidden, plan.cluster, plan.rows, plan.resident, plan.stages)


@pytest.mark.parametrize("hsz,rows", MODEL_ROWS)
def test_gru_layout_is_the_source(hsz, rows):
    """At the model's row counts the plan's shared bytes are the source's
    layout with three gate boxes (the gates [3][R][U], the W_hh^T ring and
    resident k-pairs of four gate rows a unit, the h buffer and the
    mbarriers), within SMEM_LIMIT, for the plan and for every resident
    count and ring it could have; the entries check the bytes against that
    layout."""
    plan = _plan(hsz, rows)
    _check_gru_plan(plan, hsz, rows)
    for stages in (0, 2, 3):
        top = plan.hidden // 16 - (2 if stages else 0)
        for resident in range(0 if stages else top, top + 1, 2):
            assert tg.gru_wide_smem_bytes(
                plan.hidden, plan.cluster, plan.rows, resident,
                stages) == _source_smem(plan.hidden, plan.cluster, plan.rows,
                                        resident, stages, boxes=3)
    text = _text()
    assert "smem_bytes != wide_smem(H, C, R, resident, stages, 3)" in text
    assert "wide_smem(H, cluster, rows, resident, stages, 3)" in text
    assert "wide_cta<R>(smem_raw, wf, B, H, resident, stages, 3)" in text
    assert text.count("wide_fetch_gates<3>") == 1
    assert text.count("wide_send<3>") == 1


def test_sources_declare_their_entries():
    """Without a compiler: both entries and the traced one take the
    arguments ops/_cuda.py declares (gru_scan.cu's, then the wide plan and
    the stream), the occupancy query its plan's ring, the instances are the
    shared WIDE_ROWS, the library is built with the others and the launch
    counts know both entries."""
    text = _text()
    tail = ["reverse", "cluster", "rows", "resident", "stages", "smem_bytes",
            "stream"]
    sigs = _cuda._SIGNATURES["gru_scan_wide"]
    assert set(sigs) == {*ENTRIES, "gru_scan_wide_trace"}
    assert set(tg._WIDE_ENTRIES) == set(ENTRIES)
    resident = (_cuda.CSRC / "gru_scan.cu").read_text()
    for name, argtypes in sigs.items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert len(names) == len(argtypes)
        if name == "gru_scan_wide_trace":
            assert names[-8:] == [*tail[:-1], "trace", "stream"]
            continue
        assert names[-len(tail):] == tail
        # the resident entry's arguments, the launch plan's aside
        base = re.search(rf"\bint {name[:-5]}\(([^)]*)\)", resident).group(1)
        base = [p.split()[-1].lstrip("*") for p in base.split(",")]
        assert [n.replace("wf", "wt") for n in names[:len(base) - 4]] == \
            base[:-4]
        assert tl._SOURCE_OF[name] == "gru_scan_wide"
        assert name in tl.launch_counts
    query = re.search(r"\bint gru_scan_wide_max_clusters\(([^)]*)\)", text)
    assert " ".join(query.group(1).split()) == (
        "int resident, int stages, int H, int cluster, int rows, int* n")
    assert len(_cuda._QUERIES["gru_scan_wide"][
        "gru_scan_wide_max_clusters"]) == 6
    shared = (_cuda.CSRC / SHARED).read_text()
    instances = re.search(r"#define WIDE_INSTANCES\(X\)(.*?)\n\n", shared,
                          re.S)
    assert tuple(int(n) for n in re.findall(r"X\((\d+)\)",
                                            instances.group(1))) \
        == tl.WIDE_ROWS
    assert "WIDE_INSTANCES(WIDE_RUN)" in text
    assert '#include "scan_fwd_wide.cuh"' in text
    assert "gru_scan_wide" in _cuda.SOURCES


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("hsz", [384, 512])
def test_gru_wide_weight_is_the_index_map(hsz, cluster):
    """_wide_weight of a GRU's W_hh [H, 3H], undone by the index map the
    source documents (row m of a k8 group is gate 2 hi + (r & 1) of unit 16
    wg + 4 w + r // 2, gate 3 a row of zeros), is the kernel weight
    exactly, at H padded from hsz - 20 units to the cluster's wide H."""
    hp = tl.wide_hidden(hsz - 20, cluster)
    w_hh = torch.from_numpy(_rand((hsz - 20, 3 * (hsz - 20)), hsz, 0.1))
    plan = dataclasses.replace(_plan(hsz - 20, 40), hidden=hp,
                               cluster=cluster)
    wf = tl._wide_weight(w_hh, hp, cluster)
    assert wf.dtype == torch.bfloat16 and wf.is_contiguous()
    assert wf.shape == (cluster, hp // 32, 4, 4 * hp // cluster, 8)
    assert torch.equal(wide_weight_rows(wf, plan),
                       tl._kernel_weight(w_hh, hp))
    # a quarter of the packed rows, the fourth gate's, are zero
    assert int((wf.reshape(-1, 8) == 0).all(1).sum()) >= wf.numel() // 32


@pytest.mark.parametrize("hsz,cluster,rows", [(128, 8, 16), (384, 8, 48),
                                              (512, 16, 32)])
def test_descriptors_and_lanes_give_each_cell_r_z_n(hsz, cluster, rows):
    """One step of one CTA as wgmma's K-major descriptors (the shared
    header's leading and stride byte offsets) read the packed W_hh^T slice
    and the h buffer, each warpgroup's m64 x rows accumulators placed in
    its threads as wgmma places them, and the GRU cell's exchange between
    lane and lane ^ 4 (csrc/gru_scan_wide.cu: the partner's first value
    for odd lanes' r, its second for their n, the thread's own for even
    lanes' r and n; z the other way round): every thread gets r, z and n
    of its unit at its row, equal to the product of the real layout
    (float64 of the same bf16 operands), and the b_hh values its source
    loads are its unit's."""
    units = hsz // cluster
    a_lbo, b_lbo, a_wg, sbo = _source_descriptors(units, rows)
    w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), hsz + rows, 0.1))
    b_hh = torch.from_numpy(_rand((3 * hsz,), hsz))
    h = torch.from_numpy(_rand((rows, hsz), rows)).to(torch.bfloat16)
    wt = tl._kernel_weight(w_hh, hsz).double()
    want = (wt @ h.double().t()).reshape(3, hsz, rows)   # [gate][unit][row]
    wf = tl._wide_weight(w_hh, hsz, cluster).double()
    u, n = torch.meshgrid(torch.arange(hsz), torch.arange(rows),
                          indexing="ij")
    hbuf = torch.empty(hsz * rows, dtype=torch.float64)
    hbuf[((u // 8) * rows + n) * 8 + u % 8] = h.t().double()
    lane = torch.arange(32)
    r8, tq = lane // 4, lane % 4
    e = r8 % 2
    text = _text()
    cell = {name: re.search(rf"\b{name} = e \? (.+?) : (.+?)[,;]", text)
            for name in ("ar", "az", "an")}
    bias = {name: re.search(rf"\b{name} = bhh\[(.*?)\];", text).group(1)
            for name in ("b_r", "b_z", "b_n")}
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
                d = acc[16 * w + r8[:, None, None, None]
                        + 8 * torch.arange(2)[None, :, None, None],
                        8 * torch.arange(rows // 8)[None, None, :, None]
                        + 2 * tq[:, None, None, None]
                        + torch.arange(2)[None, None, None, :]]
                # d: [lane][hi][i][c]; the partner sends its column 1 - e:
                # ra its first gate row's, rb its second's
                mine = d[lane, :, :, e]             # [lane][hi][i]
                sent = d[lane, :, :, 1 - e][lane ^ 4]
                values = {"ra": sent[:, 0], "rb": sent[:, 1],
                          "acc[4 * i]": mine[:, 0],
                          "acc[4 * i + 1]": mine[:, 0],
                          "acc[4 * i + 2]": mine[:, 1]}
                unit = rank * units + 16 * wg + 4 * w + r8 // 2
                row = (8 * torch.arange(rows // 8)[None, :]
                       + 2 * tq[:, None] + e[:, None])
                for gate, name in enumerate(("ar", "az", "an")):
                    odd, even = cell[name].groups()
                    got = torch.where(e[:, None] == 1, values[odd],
                                      values[even])
                    assert torch.equal(got, want[gate, unit[:, None], row])
                # the zero row: the even lanes' partner sends it as rb
                assert not d[lane[e == 1], 1].any()
                for gate, name in enumerate(("b_r", "b_z", "b_n")):
                    env = {"H": hsz, "col0": rank * units,
                           "ul": unit - rank * units}
                    assert torch.equal(b_hh[eval(bias[name], {}, env)],
                                       b_hh[gate * hsz + unit])


@pytest.mark.parametrize("hsz,rows", MODEL_ROWS)
def test_plans_at_the_model_rows(hsz, rows):
    """At v1-GRU's row counts over the card's occupancy (15 clusters of 8,
    7 of 16) the plan is a valid layout whose modelled waves x step no plan
    of the same cluster size with the next smaller or larger row instance
    beats; the 8 x 10 s batch's 2056 rows (and a ragged 2047) run in one
    wave of 15 clusters of 8 x 144 rows (three warpgroups a CTA, W_hh^T
    streamed) where the resident cluster needs three; the training batch's
    2304 rows in two waves of clusters of 80 rows that hold the whole
    W_hh^T slice (the fitted model puts two such steps, 8.29 us each,
    under one of 160 rows, 17.40 us) where the resident cluster needs
    five; the full band at H=512 takes clusters of 16 (two warpgroups)."""
    plan = _plan(hsz, rows)
    _check_gru_plan(plan, hsz, rows)
    best = plan.waves * plan.step_us
    at = tl.WIDE_ROWS.index(plan.rows)
    for other_rows in tl.WIDE_ROWS[max(at - 1, 0):at + 2]:
        clusters = -(-rows // other_rows)
        for stages in (0, *tl.WIDE_STAGES):
            res = tl._wide_resident(plan.hidden, plan.cluster, other_rows,
                                    stages, None, 3)
            if res is None:
                continue
            waves = -(-clusters // card_wide_occupancy(
                plan.hidden, plan.cluster, other_rows, res, stages))
            assert best <= waves * tg.gru_wide_step_us(
                plan.hidden, plan.cluster, other_rows, res, stages)
    resident = tg.plan_scan(hsz, rows, lambda c, r: card_wide_occupancy(
        hsz, c, r, 0, 1))
    if rows in (2047, 2056):
        assert (plan.cluster, plan.rows, plan.warpgroups, plan.clusters,
                plan.waves) == (8, 144, 3, 15, 1)
        assert plan.stages > 0 and resident.waves == 3
    if rows == 2304:
        assert (plan.cluster, plan.rows, plan.stages, plan.waves) == (
            8, 80, 0, 2)
        assert resident.waves == 5
        one_wave = tg.gru_wide_step_us(384, 8, 160, tl._wide_resident(
            384, 8, 160, 2, None, 3), 2)
        assert plan.waves * plan.step_us < one_wave
    if hsz == 512:
        assert plan.cluster == 16 and plan.warpgroups == 2


def test_refusals_name_the_gru():
    """Above 48 units a CTA no cluster size takes H: the planner raises
    naming the GRU scan and each cluster size's warpgroups; a plan for
    another cell's gates is refused by the GRU entries and by kernel A's,
    and _route_weight packs no weight for another cell's plan."""
    with pytest.raises(ValueError, match=r"no wide plan for the GRU scan at "
                                         r"H=1024, 18 rows: C=8: 128 units a "
                                         r"CTA need 8 warpgroups"):
        _plan(1024, 18)
    with pytest.raises(ValueError, match="no wide plan.*the card runs no"):
        tg.plan_gru_wide_scan(384, 18, lambda *a: 0)
    gru_plan = _plan(384, 40)
    lstm_plan = tl.plan_wide_scan(384, 40, card_wide_occupancy)
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="gru_scan_fwd_wide launches with a "
                                         "WidePlan of 3 gates, got 4"):
        tg._launch("gru_scan_fwd_wide", x, x, x, x, 0, 5, 40, 384, 0,
                   plan=lstm_plan)
    with pytest.raises(ValueError, match="WidePlan its weight was packed "
                                         "for, at H=384"):
        tg._launch("gru_scan_fwd_carry_wide", x, x, x, x, x, x, 0, 5, 40,
                   384, 0, plan=tl.plan_stream_scan(384, 40, stub_occupancy))
    with pytest.raises(ValueError, match="lstm_scan_fwd_wide launches with a "
                                         "WidePlan of 4 gates, got 3"):
        tl._launch("lstm_scan_fwd_wide", x, x, x, 0, 5, 40, 384, 0,
                   plan=gru_plan)
    with pytest.raises(ValueError, match="a WidePlan of 4 gates packs no "
                                         "W_hh of 3 gates"):
        tl._route_weight(torch.zeros(384, 3 * 384), 384, lstm_plan)
    with pytest.raises(ValueError, match="a WidePlan of 3 gates packs no "
                                         "W_hh of 4 gates"):
        tl._route_weight(torch.zeros(384, 4 * 384), 384, gru_plan)


def test_step_model():
    """The GRU's wide step grows with the rows and with the units a CTA;
    the streamed k-pairs cost no less than the resident ones."""
    base = tg.gru_wide_step_us(384, 8, 144, 0, 3)
    assert tg.gru_wide_step_us(384, 8, 96, 0, 3) < base
    assert tg.gru_wide_step_us(384, 8, 144, 2, 3) <= base
    assert tg.gru_wide_step_us(384, 8, 48, 24, 0) < tg.gru_wide_step_us(
        384, 8, 48, 22, 2)
    assert tg.gru_wide_step_us(256, 8, 48, 16, 0) < tg.gru_wide_step_us(
        384, 8, 48, 24, 0)
    assert len(tg._GRU_WIDE_PARTS) == 6


def _stub_card(monkeypatch):
    """card_gru_wide_plan and card_scan_plan from the card's stub occupancy,
    the route weighing them for CPU tensors as on a card; returns the
    arguments each was asked with."""
    asked = {"wide": [], "resident": []}
    monkeypatch.setattr(
        tg, "card_gru_wide_plan",
        lambda device, hsz, batch, resident=None: asked["wide"].append(
            (hsz, batch)) or tg.plan_gru_wide_scan(hsz, batch,
                                                   card_wide_occupancy,
                                                   resident))
    monkeypatch.setattr(
        tg, "card_scan_plan",
        lambda device, hsz, batch, out_dtype=torch.bfloat16, carry=False:
        asked["resident"].append((hsz, batch, out_dtype, carry))
        or tg.plan_scan(hsz, batch, lambda c, r: card_wide_occupancy(
            hsz, c, r, 0, 1)))
    monkeypatch.setattr(tg, "_on_card", lambda device: True)
    return asked


def _modelled_resident(hsz, rows):
    plan = tg.plan_scan(hsz, rows, lambda c, r: card_wide_occupancy(
        hsz, c, r, 0, 1))
    return plan.waves * tg.scan_step_us(hsz, plan.cluster, plan.rows)


def test_route_weighs_wide_against_resident(monkeypatch):
    """On a card (stubbed) the GRU forward and carry take the wide cluster
    where its modelled waves x step beat the resident cluster's, at every
    model row count and for each output type; on CPU tensors, with no
    occupancy to weigh, the resident cluster. At the 8 x 10 s batch and
    the training batch the route is the wide cluster."""
    assert tg._forward_route(384, 2056, CPU) == (384, "", None)
    asked = _stub_card(monkeypatch)
    for hsz, rows in MODEL_ROWS + ((384, 1),):
        wide = _plan(hsz, rows)
        faster = wide.waves * wide.step_us < _modelled_resident(hsz, rows)
        for instance in ((0, 0), (1, 0), (0, 1), (1, 1)):
            got = tg._forward_route(hsz, rows, CPU, instance)
            assert got == ((wide.hidden, "_wide", wide) if faster
                           else (hsz, "", None)), (hsz, rows, instance)
    assert {(h, r) for h, r, *_ in asked["resident"]} >= {(384, 2056),
                                                          (512, 18)}
    for rows in (2056, 2304):
        assert tg._forward_route(384, rows, CPU)[1] == "_wide"


def test_context_managers_force_the_gru_route(monkeypatch):
    """wide_forwards() forces the GRU's wide cluster at any row count (and
    on CPU tensors, weighing nothing), resident_forwards() its resident
    cluster where a cluster holds H, the innermost winning;
    single_block_forwards() and streamed_forwards() still win; neither
    moves the GRU backward's plan."""
    _stub_card(monkeypatch)
    stub_stream_plans(monkeypatch)
    monkeypatch.setattr(tg, "_on_card", lambda device: False)
    with tl.wide_forwards():
        for rows in (1, 18, 2056):
            assert tg._forward_route(384, rows, CPU, (1, 1)) == (
                384, "_wide", _plan(384, rows))
        with tl.resident_forwards():
            assert tg._forward_route(384, 2056, CPU) == (384, "", None)
        with tl.single_block_forwards():
            assert tg._forward_route(384, 18, CPU)[1] == "_block"
        with tl.streamed_forwards():
            assert tg._forward_route(384, 18, CPU)[1] == "_stream"
    monkeypatch.setattr(tg, "_on_card", lambda device: True)
    assert tg._forward_route(384, 2056, CPU)[1] == "_wide"
    with tl.resident_forwards():
        assert tg._forward_route(384, 2056, CPU) == (384, "", None)
        with tl.wide_forwards():
            assert tg._forward_route(384, 18, CPU)[1] == "_wide"
    assert tg._forward_route(384, 2056, CPU)[1] == "_wide"


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch
    recorded and the route weighing the stub plans as on a card."""
    calls = []
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    _stub_card(monkeypatch)
    return calls


def _check_wide_call(call, name, plan, w_hh, b_hh, out_f32, t_len, b,
                     reverse):
    got, args = call
    assert got == name
    assert args[-10:] == (out_f32, t_len, b, plan.hidden, reverse,
                          *plan.launch_args)
    assert torch.equal(wide_weight_rows(args[1], plan),
                       tl._kernel_weight(w_hh))
    assert args[2].dtype == torch.float32 and torch.equal(args[2], b_hh)


@pytest.mark.parametrize("wrapper", ["forward", "carry", "GRUScan",
                                     "chunked"])
def test_wrappers_hand_the_entries_their_plan(recorded, wrapper):
    """gru_scan_tm (fp32 out), gru_scan_carry_tm, GRUScan's forward (bf16
    h, under grad) and gru_layer_tm_chunked (a chunk of 2 of 4 steps, the
    carry entry) on a (stubbed) card at 2056 rows of H=384: each launch is
    the wide entry, its arguments the wrapper's operands (W_hh^T packed
    for wgmma with its zero rows, b_hh in fp32) ending in the plan
    card_gru_wide_plan gave."""
    t_len, b, hsz = 4, 2056, 384
    gates = torch.zeros(t_len, b, 3 * hsz, dtype=torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), 5, 0.05))
    b_hh = torch.from_numpy(_rand((3 * hsz,), 6, 0.05))
    plan = _plan(hsz, b)
    h0 = torch.zeros(b, hsz)
    if wrapper == "forward":
        with torch.no_grad():
            tg.gru_scan_tm(gates, w_hh, b_hh, True, torch.float32)
        expected = [("gru_scan_fwd_wide", 1, t_len)]
    elif wrapper == "carry":
        tg.gru_scan_carry_tm(gates, w_hh, b_hh, h0, False)
        expected = [("gru_scan_fwd_carry_wide", 0, t_len)]
    elif wrapper == "GRUScan":
        tg.gru_scan_tm(gates.float().requires_grad_(), w_hh, b_hh, True)
        expected = [("gru_scan_fwd_wide", 0, t_len)]
    else:
        x = torch.zeros(t_len, b, 8)
        w_ih = torch.zeros(8, 3 * hsz)
        with torch.no_grad():
            tg.gru_layer_tm_chunked(x, w_ih, w_hh, torch.zeros(3 * hsz), b_hh,
                                    False, 2)
        expected = [("gru_scan_fwd_carry_wide", 0, 2)] * 2
    assert len(recorded) == len(expected)
    for call, (name, out_f32, steps) in zip(recorded, expected):
        _check_wide_call(call, name, plan, w_hh, b_hh, out_f32, steps, b,
                         wrapper in ("forward", "GRUScan"))
        if name.endswith("carry_wide"):
            args = call[1]
            assert args[3].shape == (b, hsz) and args[5].dtype == torch.float32


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fake launch
    of tests/test_torch_gru.py (the wide entries unpacked to the resident
    ones' arguments) and the route weighing the stub plans as on a card."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    _stub_card(monkeypatch)
    return tl.launch_counts


def _counted(counts, expected, fn):
    for name in counts:
        counts[name] = 0
    out = fn()
    assert counts == {**dict.fromkeys(counts, 0), **expected}, counts
    return out


def _on_cpu(fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "_is_cuda", lambda *tensors: False)
        return fn()


def _chunked(gates, w_hh, b_hh, h0, reverse, out_dtype, t_chunk):
    """gru_scan_carry_tm over chunks of t_chunk steps, the carry handed on
    (from the later chunk when reversed)."""
    t_len = gates.shape[0]
    starts = list(range(0, t_len, t_chunk))
    out = torch.empty(t_len, gates.shape[1], w_hh.shape[0], dtype=out_dtype)
    h = h0
    for s in (starts[::-1] if reverse else starts):
        e = min(s + t_chunk, t_len)
        out[s:e], h = tg.gru_scan_carry_tm(gates[s:e], w_hh, b_hh, h, reverse,
                                           out_dtype)
    return out, h


@pytest.mark.parametrize("hsz", [100, 128])
def test_kernel_branch_equals_the_cpu_branch(launches, hsz):
    """At H=100 (padded to the wide cluster's units) and 128 over 40 rows
    under wide_forwards(): one gru_scan_fwd_wide a call and one
    gru_scan_fwd_carry_wide a chunk, forward and reverse, bf16 and fp32
    out, equal to the CPU branch; the chunked carry equals the unchunked
    forward and the carry's state the CPU branch's."""
    gates = torch.from_numpy(_rand((9, 40, 3 * hsz), hsz)).to(torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), hsz + 1, 0.1))
    b_hh = torch.from_numpy(_rand((3 * hsz,), hsz + 4, 0.1))
    h0 = torch.from_numpy(_rand((40, hsz), hsz + 2))
    zero = torch.zeros(40, hsz)
    for reverse in (False, True):
        for out_dtype in (torch.bfloat16, torch.float32):
            with torch.no_grad(), tl.wide_forwards():
                got = _counted(launches, {"gru_scan_fwd_wide": 1},
                               lambda: tg.gru_scan_tm(gates, w_hh, b_hh,
                                                      reverse, out_dtype))
                chunks = _counted(
                    launches, {"gru_scan_fwd_carry_wide": 3},
                    lambda: _chunked(gates, w_hh, b_hh, zero, reverse,
                                     out_dtype, 4))
                state = _counted(
                    launches, {"gru_scan_fwd_carry_wide": 1},
                    lambda: tg.gru_scan_carry_tm(gates, w_hh, b_hh, h0,
                                                 reverse, out_dtype))
            want = _on_cpu(lambda: tg.gru_scan_tm(gates, w_hh, b_hh, reverse,
                                                  out_dtype))
            assert got.dtype == out_dtype and torch.equal(got, want)
            assert torch.equal(chunks[0], want)
            want_state = _on_cpu(lambda: tg.gru_scan_carry_tm(
                gates, w_hh, b_hh, h0, reverse, out_dtype))
            for a, b in zip(state, want_state):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_route_takes_wide_on_the_kernel_branch(launches):
    """Without a context manager the kernel branch at 2056 rows of H=384
    launches the wide entry (the route on the stubbed card), at the full
    band's 8 rows of H=512 whichever design models faster, each equal to
    the CPU branch."""
    for hsz, rows in ((384, 2056), (512, 8)):
        w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), 41, 0.05))
        b_hh = torch.from_numpy(_rand((3 * hsz,), 42, 0.05))
        gates = torch.from_numpy(_rand((2, rows, 3 * hsz), 40 + rows)).to(
            torch.bfloat16)
        entry = "gru_scan_fwd" + tg._forward_route(hsz, rows, CPU)[1]
        with torch.no_grad():
            got = _counted(launches, {entry: 1},
                           lambda: tg.gru_scan_tm(gates, w_hh, b_hh))
        assert torch.equal(got, _on_cpu(lambda: tg.gru_scan_tm(gates, w_hh,
                                                               b_hh)))
    assert entry in ("gru_scan_fwd", "gru_scan_fwd_wide")


@pytest.mark.parametrize("reverse", [False, True])
def test_forward_matches_pallas_interpret(launches, reverse):
    """gru_scan_tm on the wide branch (wide_forwards()) at H=128 x 40 rows
    x T=12 against the JAX gru_scan_tm with its Pallas kernel in interpret
    mode, fp32 out: h within 5e-3."""
    hsz = 128
    gx, whh = _rand((12, 40, 3 * hsz), 21), _rand((hsz, 3 * hsz), 22, 0.08)
    bhh = _rand((3 * hsz,), 23, 0.1)
    want = np.asarray(jl.gru_scan_tm(gx, whh, bhh, reverse, 40, True,
                                     jnp.float32))
    with torch.no_grad(), tl.wide_forwards():
        got = _counted(launches, {"gru_scan_fwd_wide": 1},
                       lambda: tg.gru_scan_tm(torch.from_numpy(gx),
                                              torch.from_numpy(whh),
                                              torch.from_numpy(bhh), reverse,
                                              torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_layer_matches_pallas_interpret(launches, reverse):
    """gru_layer_tm_chunked on the wide branch (wide_forwards(): the carry
    entry, 3 chunks of 4 of T=12) at H=96 (padded to 128) x 40 rows against
    the JAX gru_layer_tm_chunked with its Pallas carry kernel in interpret
    mode, chunked the same way, fp32 out and float32 projection on both
    sides: h within 5e-3."""
    hsz, b, t_len, f = 96, 40, 12, 20
    x = _rand((t_len, b, f), 31)
    w_ih, w_hh = _rand((f, 3 * hsz), 32, 0.2), _rand((hsz, 3 * hsz), 33, 0.1)
    b_ih, b_hh = _rand((3 * hsz,), 34, 0.1), _rand((3 * hsz,), 35, 0.1)
    want = np.asarray(jl.gru_layer_tm_chunked(
        x, w_ih, w_hh, b_ih, b_hh, reverse, 4, 40, True, jnp.float32,
        jnp.float32))
    args = [torch.from_numpy(a) for a in (x, w_ih, w_hh, b_ih, b_hh)]
    with torch.no_grad(), tl.wide_forwards():
        got = _counted(launches, {"gru_scan_fwd_carry_wide": 3},
                       lambda: tg.gru_layer_tm_chunked(
                           *args, reverse, 4, torch.float32, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL, rtol=0)
