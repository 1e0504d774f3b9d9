"""The GRU backward scan as a wide cluster with both products on wgmma
(csrc/gru_scan_bwd_wide.cu: `gru_scan_bwd_wide`, the route of
`gru_scan_bwd_streams_tm` and of GRUScan's backward where its model beats
the resident cluster's) and the dW_hh contraction's new plan (ops/gru.py
plan_dwhh) on the CPU: the layout against the source, the packed weights
against the W_hh they came from, one step's two products emulated from
the source's descriptors (the swizzled A boxes, the K-major B chunks), the
planner (ops/gru.py plan_bwd_wide_scan) at the training row counts over a
stub H100 occupancy, the full band staying resident, the route between the
wide and the resident cluster and the two context managers that force one
(past the plan cache), the refusals of one-slot rings and of bytes that
are not the layout's, the plan and the packed operands the wrappers hand
the entry (a recording fake of the launch helper), the kernel branch (the
fake launch of tests/test_torch_gru.py, which unpacks the packed W_hh
operands and runs the plain version) against the CPU branch, the
contraction's slices and sum, and the plain backward and GRUScan against
the JAX package's Pallas backward in interpret mode at H=128. No JAX model
is built.

The tolerances: the packing and the emulated addressing are exact (the
emulated products sum the same bf16 operands in float32 in one order, as
the plain version's matmul does); the kernel branch equals the CPU branch
bit for bit in the scan (the fake computes the plain version on the real
units, which the padded units leave unchanged) and within 1e-6 of the
norm in dW_hh (its partials are summed in another order than one
product's); against Pallas the bf16 ones of tests/test_torch_gru.py, 1e-2
absolute and relative on dgx, dW_hh and the db_hh partials (the same bf16
algorithm, other orders of the sums and other transcendental functions: a
float32 difference that crosses a bf16 rounding boundary moves a dgates
entry by one bf16 step, 2^-8 relative, which dh carries to earlier
steps), and on the gradients against jax.grad the JAX tests' 2e-2
absolute, 1e-2 relative.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from test_torch_gru import fake_launch
from torch_stream_stubs import stub_bwd_plans, wide_bwd_weight_rows

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
EXACT = dict(atol=2e-2, rtol=1e-2)
SOURCE = "gru_scan_bwd_wide.cu"
TRAIN_ROWS = (2304, 2295, 1152, 1024)
BLOCK = 16          # the Pallas backward's batch block: one db_hh partial


def _h100(cluster, rows, resident=False):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM, as
    tests/test_torch_bwd_plan.py's."""
    return 15 if cluster == 8 else 7


def stub_wide(hsz, cluster, rows, tiles, groups, resident, stages, pieces):
    """Clusters of the wide backward an H100 runs at once, as _h100 (kernel
    D's occupancy signature, which the GRU's planner calls too)."""
    return _h100(cluster, rows)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _source_fn(name, **env):
    """The source's function `name` evaluated: its return expression with
    the casts dropped and integer division, its `const size_t` locals
    first."""
    text = (_cuda.CSRC / SOURCE).read_text()
    body = re.search(rf"\b{name}\([^)]*\) \{{(.*?)\}}", text, re.S).group(1)

    def py(expr):
        return " ".join(expr.replace("(size_t)", "").replace(
            "/", "//").split()).rstrip(";")

    for local in re.findall(r"const size_t (.*?);", body, re.S):
        for part in re.split(r",\s*(?![^()]*\))", local):
            key, expr = part.split("=", 1)
            env[key.strip()] = eval(py(expr), {}, env)
    return eval(py(body[body.rindex("return") + 6:]), {}, env)


def _source_smem(hsz, cluster, rows, stages):
    return _source_fn(
        "wide_bwd_smem", H=hsz, C=cluster, R=rows, stages=stages,
        a_slot=lambda r: _source_fn("a_slot", R=r),
        w_slot=lambda u: _source_fn("w_slot", U=u))


def _check_plan(plan, hsz, batch):
    hp = plan.hidden
    assert hp == tg.bwd_wide_hidden(hsz, plan.cluster) >= hsz
    assert hp % (16 * plan.cluster) == 0 and hp % 64 == 0
    assert hp // plan.cluster in tg.BWD_WIDE_UNITS
    assert plan.rows in tg.BWD_WIDE_ROWS and plan.warpgroups == plan.rows // 64
    assert plan.stages in tg.BWD_WIDE_STAGES and plan.stages >= 2
    assert plan.clusters == -(-batch // plan.rows)
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.smem_bytes == tg.bwd_wide_smem_bytes(
        hp, plan.cluster, plan.rows, plan.stages)
    assert plan.smem_bytes <= tl.SMEM_LIMIT
    assert plan.step_us == tg.bwd_wide_step_us(hp, plan.cluster, plan.rows,
                                               plan.stages)
    assert plan.design == "wide"
    assert plan.launch_args == (plan.cluster, plan.rows, plan.stages,
                                plan.smem_bytes)


@pytest.mark.parametrize("hsz", [128, 384, 512])
def test_wide_layout_is_the_source(hsz):
    """The plans at the training row counts: the shared bytes are the
    source's layout (the ring of swizzled boxes and weight chunks, the
    cell's five operands, b_hh and the tiles' db_hh sums, the mbarriers),
    for the plan and for every ring it could have; a ring one slot deeper
    than the deepest that fits does not fit."""
    for rows in TRAIN_ROWS + (18,):
        plan = tg.plan_bwd_wide_scan(hsz, rows, stub_wide)
        _check_plan(plan, hsz, rows)
        for stages in range(1, 8):
            assert tg.bwd_wide_smem_bytes(
                plan.hidden, plan.cluster, plan.rows, stages) == _source_smem(
                    plan.hidden, plan.cluster, plan.rows, stages)
        deepest = max(d for d in tg.BWD_WIDE_STAGES if tg.bwd_wide_smem_bytes(
            plan.hidden, plan.cluster, plan.rows, d) <= tl.SMEM_LIMIT)
        assert plan.stages <= deepest
    # at v1's sub-band width a CTA of 192 rows takes four slots
    assert tg.bwd_wide_smem_bytes(384, 8, 192, 4) == 216896 <= tl.SMEM_LIMIT
    assert tg.bwd_wide_smem_bytes(384, 8, 192, 5) > tl.SMEM_LIMIT


@pytest.mark.parametrize("rows", TRAIN_ROWS)
def test_plans_at_the_training_rows(rows):
    """At v1's sub-band training batch (2304 rows, 2295 ragged) one wave of
    12 clusters of 8 x 192 rows, where the resident cluster runs ten; at a
    band rank's 1152 rows and at 1024 one wave; each modelled faster than
    the resident cluster, and no other row count or ring of the same
    cluster size models faster; an occupancy of two CTAs an SM counts as
    one."""
    plan = tg.plan_bwd_wide_scan(384, rows, stub_wide)
    _check_plan(plan, 384, rows)
    with tl.resident_backwards():
        resident = tg.plan_bwd_scan(384, rows, _h100)
    assert resident.design == "cluster"
    assert plan.waves * plan.step_us < resident.waves * resident.step_us
    assert plan.waves == 1 and (plan.cluster, plan.hidden) == (8, 384)
    if rows > 2048:
        assert (plan.rows, plan.clusters, plan.stages) == (192, 12, 4)
        assert resident.waves == 10
    # an occupancy of two CTAs an SM is used as one (the step model's)
    two = tg.plan_bwd_wide_scan(384, rows, lambda h, c, *a: 264 // c)
    assert two.active == 132 // two.cluster
    for other in tg.BWD_WIDE_ROWS:
        for stages in tg.BWD_WIDE_STAGES:
            if tg.bwd_wide_smem_bytes(384, 8, other, stages) > tl.SMEM_LIMIT:
                continue
            alt = tg.bwd_wide_step_us(384, 8, other, stages) * -(
                -(-(-rows // other)) // 15)
            assert plan.waves * plan.step_us <= alt + 1e-9


def test_full_band_stays_resident():
    """At the full band (H=512 x 18 rows, and one row) the resident cluster
    models faster than the wide one (16 CTAs of 32 units x 64 rows), so
    the plan is unchanged."""
    for rows in (18, 1):
        plan = tg.plan_bwd_scan(512, rows, _h100)
        wide = tg.plan_bwd_wide_scan(512, rows, stub_wide)
        _check_plan(wide, 512, rows)
        assert (wide.cluster, wide.rows) == (16, 64)
        assert plan.design == "cluster" and (plan.cluster, plan.rows) == (
            16, 16)
        assert plan.waves * plan.step_us < wide.waves * wide.step_us


@pytest.mark.parametrize("hsz", [384, 512])
def test_route_weighs_wide_against_resident(hsz):
    """plan_bwd_scan takes the GRU's wide cluster where its modelled waves x
    step beat the resident cluster's (and the single block's), at every
    row count, and else keeps the resident plan."""
    for rows in TRAIN_ROWS + (1, 18, 36, 257, 2056):
        wide = tg.plan_bwd_wide_scan(hsz, rows, stub_wide)
        with tl.resident_backwards():
            resident = tg.plan_bwd_scan(hsz, rows, _h100)
        got = tg.plan_bwd_scan(hsz, rows, _h100, wide_clusters=stub_wide)
        if wide.waves * wide.step_us < resident.waves * resident.step_us:
            assert got == wide, rows
        else:
            assert got == resident, rows
    assert tg.plan_bwd_scan(384, 2304, _h100).design == "wide"
    assert tg.plan_bwd_scan(384, 2304, _h100,
                            wide_clusters=lambda *a: 0).design == "cluster"


@pytest.fixture
def card_plans(monkeypatch):
    """card_bwd_scan_plan's plumbing on the CPU: the stub H100 occupancy of
    every design in place of the card's queries; the plan cache cleared
    before and after."""
    monkeypatch.setattr(tg, "_device_index", lambda device: 0)
    monkeypatch.setattr(tg, "_card_wide_bwd_occupancy",
                        lambda index: stub_wide)
    monkeypatch.setattr(
        tg, "card_bwd_plan", lambda source, plan, device, hsz, batch: plan(
            hsz, batch, lambda c, r, res: _h100(c, r), tl.H100_SMS,
            lambda *a: 8))
    tg._card_bwd_scan_plan.cache_clear()
    yield torch.device("cpu")
    tg._card_bwd_scan_plan.cache_clear()


def test_context_managers_force_the_design_past_the_cache(card_plans):
    """card_bwd_scan_plan is cached on the forced design too:
    wide_backwards() forces the wide plan at 18 rows and
    resident_backwards() the resident cluster at 2304 rows, each after the
    unforced plan of the same shape was cached; the innermost wins, and
    kernel D's plan is left as it was."""
    dev = card_plans
    assert tg.card_bwd_scan_plan(dev, 384, 18).design == "cluster"
    assert tg.card_bwd_scan_plan(dev, 384, 2304).design == "wide"
    with tl.wide_backwards():
        assert tg.card_bwd_scan_plan(dev, 384, 18) == tg.plan_bwd_wide_scan(
            384, 18, stub_wide)
        with tl.resident_backwards():
            assert tg.card_bwd_scan_plan(dev, 384, 2304).design == "cluster"
        assert tg.card_bwd_scan_plan(dev, 384, 2304).design == "wide"
    with tl.resident_backwards():
        assert tg.card_bwd_scan_plan(dev, 384, 2304).design == "cluster"
    assert tg.card_bwd_scan_plan(dev, 384, 18).design == "cluster"
    assert tg.card_bwd_scan_plan(dev, 384, 2304).design == "wide"
    assert tg._card_bwd_scan_plan.cache_info().currsize == 5
    with tl.wide_forwards():
        assert tg.card_bwd_scan_plan(dev, 384, 18).design == "cluster"


def test_refusals_name_the_bytes():
    """Where no CTA holds an instance's units, the planner raises naming
    each cluster size's reason; no plan has a ring of one slot, and the
    source refuses one and bytes that are not the layout's; a plan that is
    not the entry's GruBwdWidePlan at the H given is refused before
    anything launches, and the resident entry refuses a wide plan."""
    with pytest.raises(ValueError, match=r"no wide plan for the GRU backward "
                                         r"scan at H=4096, 18 rows: C=8: 512 "
                                         r"units a CTA"):
        tg.plan_bwd_wide_scan(4096, 18, stub_wide)
    with pytest.raises(ValueError, match="no wide plan.*the card runs no"):
        tg.plan_bwd_wide_scan(384, 18, lambda *a: 0)
    seen = []
    tg.plan_bwd_wide_scan(384, 2304, lambda *a: seen.append(a[-2:]) or 15)
    assert seen and all(stages == pieces >= 2 for stages, pieces in seen)
    text = (_cuda.CSRC / SOURCE).read_text()
    fits = re.search(r"bool bwd_plan_fits\(.*?\n\}", text, re.S).group(0)
    assert "stages >= 2" in fits
    assert ("smem_bytes != wide_bwd_smem(H, C, R, stages)") in text
    plan = tg.plan_bwd_wide_scan(384, 40, lambda h, c, *a: 15 if c == 8
                                 else 0)
    assert plan.hidden == 384
    x = torch.zeros(2, 16)
    args = (x,) * 9 + (3, 5, 40, 384, 0)
    for bad in (None, tg.plan_bwd_scan(384, 40, _h100),
                tg.plan_bwd_wide_scan(512, 40, stub_wide),
                tl.plan_bwd_wide(384, 40, stub_wide)):
        with pytest.raises(ValueError, match="GruBwdWidePlan its weight was "
                                             "packed for, at H=384"):
            tg._launch("gru_scan_bwd_wide", *args, plan=bad)
    with pytest.raises(ValueError, match="gru_scan_bwd launches with a "
                                         "BwdPlan, got GruBwdWidePlan"):
        tg._launch("gru_scan_bwd", *(x,) * 10, 3, 5, 40, 384, 0, plan=plan)
    with pytest.raises(ValueError, match="a wide plan at H=384 is for no "
                                         "layer of 512 units"):
        tg._wide_bwd_hidden(512, plan)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "_launch_entry", lambda *a: seen.append(a))
        tg._launch("gru_scan_bwd_wide", *args, plan=plan)
    assert seen == [("gru_scan_bwd_wide", *args, *plan.launch_args)]


def test_sources_declare_their_entries():
    """Without a compiler: the entry and its traced twin take the arguments
    ops/_cuda.py declares, ending in the plan (and the trace) and the
    stream, the occupancy query its instance flag, the instances are the
    planner's units, both products run on wgmma (no mma.sync left), the
    k order walks dgx's r and z columns and then dhn, and the launch counts
    know the entry."""
    text = (_cuda.CSRC / SOURCE).read_text()
    tail = ["n_blocks", "T", "B", "H", "reverse", "cluster", "rows",
            "stages", "smem_bytes"]
    for name, argtypes in _cuda._SIGNATURES["gru_scan_bwd_wide"].items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        want = tail + (["trace"] if name.endswith("_trace") else [])
        assert len(names) == len(argtypes)
        assert names[-len(want) - 1:] == want + ["stream"]
        assert names[:9] == ["gates", "h_seq", "gout", "wrec", "wdh", "bhh",
                             "dgx", "dhn", "dbhh"]
    query = re.search(r"\bint gru_scan_bwd_wide_max_clusters\(([^)]*)\)",
                      text)
    assert " ".join(query.group(1).split()) == (
        "int stages, int H, int cluster, int rows, int* n")
    instances = re.findall(r"X\((\d+), (\d+)\)", re.search(
        r"#define GRU_BWD_INSTANCES\(X\)(.*?)\n\n", text, re.S).group(1))
    assert sorted((int(u), int(r)) for u, r in instances) == [
        (u, r) for u in tg.BWD_WIDE_UNITS for r in tg.BWD_WIDE_ROWS]
    assert "mma16816" not in text and "mma.sync" not in text.split(
        "#include")[1]
    assert "stage_mma<N3>(zacc" in text and "stage_mma<U>(acc" in text
    assert "NC1 = 2 * H / 64" in text and "64 * (c - NC1)" in text
    assert tl._SOURCE_OF["gru_scan_bwd_wide"] == "gru_scan_bwd_wide"
    assert "gru_scan_bwd_wide" in tl.launch_counts
    assert '#include "scan_fwd_wide.cuh"' in text
    assert '#include "scan_bwd_wide.cuh"' in (
        _cuda.CSRC / "lstm_scan_bwd_wide.cu").read_text()


@pytest.mark.parametrize("hsz,cluster", [(384, 8), (512, 16), (100, 8)])
def test_packed_weights_give_w_hh_back(hsz, cluster):
    """_wide_bwd_weights of seeded bf16 weights: each operand's shape, its
    index map undone (tests/torch_stream_stubs.py wide_bwd_weight_rows)
    gives the zero-padded W_hh exactly, and both operands hold the same
    weight."""
    w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), hsz)).to(torch.bfloat16)
    hp = tg.bwd_wide_hidden(hsz, cluster)
    plan = tg.GruBwdWidePlan(hp, cluster, 64, 2, 1, 1, 1, 0, 0.0)
    wrec, wdh = tg._wide_bwd_weights(w_hh, hp, cluster)
    assert wrec.dtype == wdh.dtype == torch.bfloat16
    assert wrec.is_contiguous() and wdh.is_contiguous()
    assert torch.equal(wide_bwd_weight_rows(wrec, wdh, plan),
                       tl._padded_weight(w_hh, hp))


def _b_operand(chunk, n, kk):
    """The [16 x n] B operand of k16 step kk that wgmma reads from a packed
    chunk (flat bf16, [8 k8 groups][n][8]) through the source's K-major
    descriptor: start 2 kk n 16 bytes on, leading offset n 16 bytes (the
    k8 groups), stride 128 bytes (8 rows), 16 bytes a row of a core
    matrix."""
    k, col = torch.meshgrid(torch.arange(16), torch.arange(n), indexing="ij")
    byte = (2 * kk * n * 16 + k // 8 * n * 16 + col // 8 * 128
            + col % 8 * 16 + k % 8 * 2)
    return chunk[byte // 2]


def _a_operand(box, row0, kk):
    """The [64 x 16] A operand of k16 step kk that wgmma reads from a box of
    64-column rows as TMA's 128-byte swizzle wrote it (16-byte piece c of
    row r at c ^ (r & 7)), through the source's descriptor: start row0 x
    128 + 32 kk bytes on, 8 rows 1024 bytes apart, the swizzle on the
    address bits."""
    r, k = torch.meshgrid(torch.arange(64), torch.arange(16), indexing="ij")
    row = row0 + r
    plain = row * 128 + 32 * kk + k // 8 * 16          # before the swizzle
    piece = (plain % 128) // 16 ^ (row % 8)
    byte = row * 128 + piece * 16 + k % 8 * 2
    flat = box.flatten()
    return flat[byte // 2]


def _swizzled(x):
    """A box [R][64] as TMA's SWIZZLE_128B lays it in shared memory."""
    out = torch.empty_like(x)
    rows = torch.arange(x.shape[0])
    for c in range(8):
        dst = (c ^ (rows % 8)) * 8
        for j in range(8):
            out[rows, dst + j] = x[:, 8 * c + j]
    return out


@pytest.mark.parametrize("hsz,cluster", [(384, 8), (512, 16)])
def test_one_step_products_emulated(hsz, cluster):
    """One step's two products of one CTA (rank 1) and warpgroup (rows
    64-127 of 192) emulated as the source addresses them: the h_prev boxes
    swizzled as TMA writes them, read through the A descriptor, against the
    recompute's W_hh^T chunks through the B descriptor, k16 step after k16
    step; then a dgh tile's pieces against the W_hh rows. Both equal the
    plain products of the CTA's columns (gate-major) and units."""
    rng = np.random.default_rng(hsz)
    units, rank, rows, wg = hsz // cluster, 1, 192, 1
    w = torch.from_numpy(rng.standard_normal((hsz, 3 * hsz)).astype(
        np.float32)).to(torch.bfloat16)
    h = torch.from_numpy(rng.standard_normal((rows, hsz)).astype(
        np.float32)).to(torch.bfloat16)
    dgh = torch.from_numpy(rng.standard_normal((rows, 3 * hsz)).astype(
        np.float32)).to(torch.bfloat16)
    wrec, wdh = tg._wide_bwd_weights(w, hsz, cluster)
    gh = torch.zeros(64, 3 * units)
    for b in range(hsz // 64):
        box = _swizzled(h[:, 64 * b:64 * b + 64])
        chunk = wrec[rank, b].flatten()
        for kk in range(4):
            gh += (_a_operand(box, 64 * wg, kk).float()
                   @ _b_operand(chunk, 3 * units, kk).float())
    cols = torch.cat([q * hsz + rank * units + torch.arange(units)
                      for q in range(3)])
    rows_wg = slice(64 * wg, 64 * wg + 64)
    want = h[rows_wg].float() @ w[:, cols].float()
    torch.testing.assert_close(gh, want, rtol=1e-5, atol=1e-4)
    dh = torch.zeros(64, units)
    for c in range(3 * hsz // 64):
        box = _swizzled(dgh[:, 64 * c:64 * c + 64])
        chunk = wdh[rank, c].flatten()
        for kk in range(4):
            dh += (_a_operand(box, 64 * wg, kk).float()
                   @ _b_operand(chunk, units, kk).float())
    want = dgh[rows_wg].float() @ w[rank * units:(rank + 1) * units].float().t()
    torch.testing.assert_close(dh, want, rtol=1e-5, atol=1e-4)


def _operands(t_len, b, hsz, seed):
    gates = torch.from_numpy(_rand((t_len, b, 3 * hsz), seed)).to(
        torch.bfloat16)
    h_seq, gout = (torch.from_numpy(_rand((t_len, b, hsz), seed + i)).to(
        torch.bfloat16) for i in (1, 2))
    w_hh = torch.from_numpy(_rand((hsz, 3 * hsz), seed + 3, 0.1))
    b_hh = torch.from_numpy(_rand((3 * hsz,), seed + 4, 0.1))
    return gates, h_seq, gout, w_hh, b_hh


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch
    recorded and the backward plans from the stub occupancy."""
    calls = []
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_launch_entry",
                        lambda name, *args: calls.append((name, args)))
    stub_bwd_plans(monkeypatch)
    return calls


def test_wrappers_hand_the_entry_its_plan(recorded, monkeypatch):
    """gru_scan_bwd_streams_tm at 2304 rows of H=384: on CPU tensors, with
    no card's occupancy, the resident entry (its plan asked at launch);
    within wide_backwards(), on a (stubbed) card, and through the planned
    wrapper one launch of the wide entry whose arguments are the wrapper's
    operands (W_hh packed twice as wgmma's B operands for the plan's
    cluster, b_hh in fp32, the three outputs and one db_hh partial a 16-row
    tile) and end in the plan."""
    t_len, b, hsz = 2, 2304, 384
    ops = _operands(t_len, b, hsz, 7)
    plan = tg.plan_bwd_wide_scan(hsz, b, stub_wide)
    tg.gru_scan_bwd_streams_tm(*ops, reverse=True)
    with tl.wide_backwards():
        tg.gru_scan_bwd_streams_tm(*ops, reverse=True)
    monkeypatch.setattr(tg, "_on_card", lambda device: True)
    tg.gru_scan_bwd_streams_tm(*ops, reverse=True)
    tg.gru_scan_bwd_streams_planned_tm(*ops, plan, reverse=True)
    assert [name for name, _ in recorded] == ["gru_scan_bwd"] + [
        "gru_scan_bwd_wide"] * 3
    with tl.resident_backwards():
        resident = tg.plan_bwd_scan(hsz, b, _h100)
    assert recorded[0][1][-9:] == (144, t_len, b, hsz, 1,
                                   *resident.launch_args)
    for _, args in recorded[1:]:
        assert args[-9:] == (144, t_len, b, hsz, 1, *plan.launch_args)
        assert args[0] is ops[0] and args[1] is ops[1] and args[2] is ops[2]
        assert torch.equal(wide_bwd_weight_rows(args[3], args[4], plan),
                           tl._padded_weight(ops[3], hsz))
        assert args[5].dtype == torch.float32 and torch.equal(args[5], ops[4])
        assert args[6].shape == (t_len, b, 3 * hsz)
        assert args[7].shape == (t_len, b, hsz)
        assert args[8].shape == (144, 3 * hsz)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fake launch
    of tests/test_torch_gru.py and the backward plans from the stub
    occupancy."""
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_bwd_plans(monkeypatch)
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


@pytest.mark.parametrize("hsz", [100, 128])
def test_kernel_branch_equals_the_cpu_branch(launches, hsz):
    """At H=100 (padded to the wide cluster's units) and 128 over 40 rows
    under wide_backwards(): one gru_scan_bwd_wide a call, forward and
    reverse, equal to the CPU branch (dgx, dhn, db_hh); GRUScan's gradients
    (one forward, one wide backward, one contraction) equal the CPU
    branch's, dW_hh within 1e-6 of its norm."""
    ops = _operands(5, 40, hsz, hsz)
    for reverse in (False, True):
        with tl.wide_backwards():
            got = _counted(launches, {"gru_scan_bwd_wide": 1},
                           lambda: tg.gru_scan_bwd_streams_tm(*ops, reverse))
        want = _on_cpu(lambda: tg.gru_scan_bwd_streams_tm(*ops, reverse))
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-6)

        def grads():
            g = ops[0].float().requires_grad_()
            w = ops[3].clone().requires_grad_()
            bias = ops[4].clone().requires_grad_()
            (tg.gru_scan_tm(g, w, bias, reverse, torch.float32) ** 2).sum(
            ).backward()
            return g.grad, w.grad, bias.grad

        with tl.wide_backwards():
            got = _counted(launches, {"gru_scan_fwd": 1,
                                      "gru_scan_bwd_wide": 1,
                                      "gru_scan_bwd_dwhh": 1}, grads)
        want = _on_cpu(grads)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            assert (a - b).norm() <= 1e-6 * b.norm()


@pytest.mark.parametrize("hsz,n", [(384, 194 * 2304), (384, 194 * 2295),
                                   (512, 194 * 18), (128, 194 * 1024),
                                   (16, 114)])
def test_dwhh_plan_fills_the_card(hsz, n):
    """plan_dwhh fills the card (the working CTAs one wave; one more slice
    of every full tile would not fit, or would model no faster), no slice
    empty; the first design's plan keeps its 12 H floor."""
    plan = tg.plan_dwhh(n, hsz)
    full, narrow, _ = tg._dwhh_tiles(hsz)
    working = full * plan.slices + narrow * plan.narrow_slices
    assert working <= tl.H100_SMS
    assert (working + full > tl.H100_SMS or plan.rows_per_slice <= 64
            or tg.dwhh_us(n, hsz, plan.slices + 1, plan.narrow_slices)
            >= plan.us)
    for per, count in ((plan.rows_per_slice, plan.slices),
                       (plan.narrow_rows, plan.narrow_slices)):
        assert per * (count - 1) < n <= per * count and per % 64 == 0
    first = tg.plan_dwhh_first(n, hsz)
    assert first.in_flight == 0 and first.narrow_slices == first.slices
    assert first.slices == 1 or first.rows_per_slice >= 12 * hsz - 64


def test_contraction_sums_its_partials_in_a_fixed_order(launches):
    """gru_dwhh on the kernel's branch (the fake launch writes each slice's
    partial as the kernel cuts the rows, the narrow tiles' columns their
    own way) returns the partials' sum over the slices, the same bits in
    two runs and under the first design's plan within 1e-6 of the norm,
    and the plain contraction within 1e-5 of the norm."""
    n, hsz = 194 * 40, 64
    rng = np.random.default_rng(5)
    h_prev, dgx, dhn = (torch.from_numpy(rng.standard_normal(
        (n, k * hsz)).astype(np.float32)).to(torch.bfloat16)
        for k in (1, 3, 1))
    plan = tg.plan_dwhh(n, hsz)
    assert plan.slices > 1
    a = _counted(launches, {"gru_scan_bwd_dwhh": 1},
                 lambda: tg.gru_dwhh(h_prev, dgx, dhn))
    assert torch.equal(a, tg.gru_dwhh(h_prev, dgx, dhn))
    part = torch.empty(plan.slices, hsz, 3 * hsz)
    fake_launch("gru_scan_bwd_dwhh", h_prev, dgx, dhn, part, n, hsz,
                plan=plan)
    assert torch.equal(a, part.sum(dim=0))
    first = tg.gru_dwhh(h_prev, dgx, dhn, plan=tg.plan_dwhh_first(n, hsz))
    want = tg.gru_dwhh_reference(h_prev, dgx, dhn)
    assert (a - first).norm() <= 1e-6 * want.norm()
    assert (a - want).norm() <= 1e-5 * want.norm()


def _pallas_bwd(gx, whh, bhh, gout, reverse):
    """The Pallas forward's bf16 h sequence and its backward kernel in
    interpret mode over the batch padded to BLOCK rows: (h_seq, dgx,
    dW_hh summed over the blocks, db_hh partials [blocks, 3H])."""
    b = gx.shape[1]
    b_pad = -(-b // BLOCK) * BLOCK
    pad = ((0, 0), (0, b_pad - b), (0, 0))
    gx_pad = jnp.asarray(np.pad(gx, pad), jnp.bfloat16)
    h_seq = jl._gru_pallas_call(gx_pad, whh, bhh, block_b=BLOCK,
                                interpret=True, out_dtype=jnp.bfloat16,
                                reverse=reverse)
    dgx, dw, db = jl._gru_pallas_call_bwd(
        gx_pad, h_seq, jnp.asarray(np.pad(gout, pad), jnp.bfloat16), whh, bhh,
        block_b=BLOCK, interpret=True, reverse=reverse)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return (f32(h_seq)[:, :b], f32(dgx)[:, :b], f32(dw).sum(axis=0),
            f32(db)[:, 0])


@pytest.mark.parametrize("t_len,reverse", [(6, False), (6, True), (1, False),
                                           (1, True)])
def test_wide_backward_matches_pallas_interpret(launches, t_len, reverse):
    """The wide branch (a wide plan of the stub occupancy, its padded H)
    at H=128 over a ragged 19 rows, T=6 and T=1: dgx and each db_hh partial
    (one a 16-row tile, as the Pallas kernel's blocks of 16) against
    _gru_pallas_call_bwd on the same residuals and cotangent, and dW_hh
    (the contraction of its dgx and dhn) against the Pallas blocks' sum."""
    hsz, b = 128, 19
    gx = _rand((t_len, b, 3 * hsz), 60 + t_len)
    whh = _rand((hsz, 3 * hsz), 61, 0.2)
    bhh = _rand((3 * hsz,), 62, 0.1)
    gout = _rand((t_len, b, hsz), 63)
    h_seq, want_dgx, want_dw, want_db = _pallas_bwd(gx, whh, bhh, gout,
                                                    reverse)
    ops = (torch.from_numpy(gx).to(torch.bfloat16),
           torch.from_numpy(h_seq.copy()).to(torch.bfloat16),
           torch.from_numpy(gout).to(torch.bfloat16),
           torch.from_numpy(whh), torch.from_numpy(bhh))
    plan = tg.plan_bwd_wide_scan(hsz, b, stub_wide)
    dgx, dhn, db = _counted(launches, {"gru_scan_bwd_wide": 1},
                            lambda: tg.gru_scan_bwd_streams_planned_tm(
                                *ops, plan, reverse))
    assert db.shape == (2, 3 * hsz)
    np.testing.assert_allclose(dgx.float().numpy(), want_dgx, **BF16)
    np.testing.assert_allclose(db.numpy(), want_db, **BF16)
    dw = tg.gru_dwhh(*tg.shifted_rows(ops[1], dgx, dhn, reverse)) \
        if t_len > 1 else torch.zeros(hsz, 3 * hsz)
    np.testing.assert_allclose(dw.numpy(), want_dw, **BF16)
    # the plain backward gives the same bits as the wide branch
    plain = tg.gru_scan_bwd_streams_reference_tm(*ops, reverse)
    assert torch.equal(plain[0], dgx) and torch.equal(plain[1], dhn)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_gradients_match_pallas_interpret(launches, reverse):
    """GRUScan on the wide branch (wide_backwards()) at H=128 x 19 rows x
    T=5, for a random cotangent, against jax.grad of the JAX package's
    gru_scan_tm, whose forward and backward run the Pallas kernels in
    interpret mode; one forward, one wide backward and one contraction."""
    hsz, b, t_len = 128, 19, 5
    gx = _rand((t_len, b, 3 * hsz), 71)
    whh = _rand((hsz, 3 * hsz), 72, 0.2)
    bhh = _rand((3 * hsz,), 73, 0.1)
    ct = _rand((t_len, b, hsz), 74)

    def jax_loss(g_, w_, b_):
        y = jl.gru_scan_tm(g_, w_, b_, reverse, 256, True, jnp.float32)
        return jnp.sum(y * ct)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(gx, whh, bhh)

    def grads():
        ts = [torch.from_numpy(a).requires_grad_() for a in (gx, whh, bhh)]
        y = tg.gru_scan_tm(*ts, reverse, torch.float32)
        (y * torch.from_numpy(ct)).sum().backward()
        return [t.grad.numpy() for t in ts]

    with tl.wide_backwards():
        got = _counted(launches, {"gru_scan_fwd": 1, "gru_scan_bwd_wide": 1,
                                  "gru_scan_bwd_dwhh": 1}, grads)
    for a, w_ in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w_), **EXACT)
