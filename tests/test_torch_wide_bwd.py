"""Kernel D as a wide cluster (csrc/lstm_scan_bwd_wide.cu:
`lstm_scan_bwd_wide`, the route of `lstm_scan_bwd_tm` and of LSTMScan's
backward where its model beats the resident cluster's) on the CPU: the
layout against the source, the planner (ops/lstm.py plan_bwd_wide) at the
training row counts over the stub H100 occupancy of
tests/torch_stream_stubs.py, its refusals, the step model, the route
between the wide and the resident cluster (plan_bwd, by modelled waves x
step) and the two context managers that force one, the plan the wrappers
hand the entry (a recording fake of `_launch_kernel`), the kernel branch
(the fake launch of tests/test_torch_lstm_backward.py, which unpacks the
packed W_hh operands and runs the plain version) against the CPU branch,
and LSTMScan against the JAX package's Pallas backward in interpret mode at
a small H. No JAX model is built.

The tolerances: the kernel branch equals the CPU branch bit for bit (the
fake computes the plain version on the real units, which the padded units
leave unchanged); against Pallas the bf16 ones, 1e-2 absolute and relative
on dgates, and on dW_hh 1e-2 of its largest entry absolute and 1e-2
relative: both sides compute the same bf16 algorithm and differ in the
order of the sums and in the transcendental functions, and a float32
difference that crosses a bf16 rounding boundary moves a dgates entry by
one bf16 step (2^-8 relative), which dh carries to earlier steps and
dW_hh sums over T x B rows.
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
from test_torch_lstm_backward import fake_launch
from torch_stream_stubs import stream_dh_weight_rows, stream_weight_rows
from torch_stream_stubs import stub_bwd_plans

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
CPU = torch.device("cpu")
SOURCE = "lstm_scan_bwd_wide.cu"
TRAIN_ROWS = (2304, 2295, 1024)


def _h100(cluster, rows, resident=False):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM, as
    tests/test_torch_bwd_plan.py's."""
    return 15 if cluster == 8 else 7


def stub_wide_bwd_occupancy(hsz, cluster, rows, tiles, groups, resident,
                            stages, pieces):
    """Clusters of the wide backward an H100 runs at once (one CTA an SM),
    as _h100."""
    return _h100(cluster, rows)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _source_fn(name, **env):
    """The source's function `name` (a body without braces) evaluated: its
    return expression with the casts dropped and integer division, its
    `const size_t` locals first."""
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


def _source_smem(hsz, cluster, rows, resident, stages, pieces):
    return _source_fn("wide_bwd_smem", H=hsz, C=cluster, R=rows,
                      resident=resident, stages1=stages, stages2=pieces,
                      pair_bytes=lambda u: _source_fn("pair_bytes", U=u))


def _check_plan(plan, hsz, batch):
    hp = plan.hidden
    assert hp == tl.stream_hidden(hsz, plan.cluster) >= hsz
    assert hp % (8 * plan.cluster) == 0 and hp % 64 == 0
    assert (plan.tiles, plan.groups) in tl.BWD_WIDE_ITEMS
    assert plan.rows % (16 * plan.tiles) == 0 and plan.rows <= 256
    assert hp // plan.cluster <= 256
    assert hp // plan.cluster // 8 % plan.groups == 0
    assert 1 <= tl.bwd_wide_items(hp, plan.cluster, plan.rows, plan.tiles,
                                  plan.groups) <= tl._BWD_WIDE_MAX_ITEMS[
                                      plan.tiles, plan.groups]
    assert plan.resident % 2 == 0 and plan.resident <= hp // 16
    assert (plan.stages == 0) == (plan.resident == hp // 16)
    assert plan.stages <= hp // 32 - plan.resident // 2 or not plan.stages
    assert plan.pieces in tl.BWD_WIDE_STAGES
    assert plan.clusters == -(-batch // plan.rows)
    assert (plan.clusters - 1) * plan.rows < batch
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.smem_bytes == tl.bwd_wide_smem_bytes(
        hp, plan.cluster, plan.rows, plan.resident, plan.stages, plan.pieces)
    assert plan.smem_bytes <= tl.SMEM_LIMIT and plan.smem_bytes % 8 == 0
    assert plan.step_us == tl.bwd_wide_step_us(
        hp, plan.cluster, plan.rows, plan.tiles, plan.groups, plan.resident,
        plan.stages, plan.pieces)
    assert plan.design == "wide"
    assert plan.launch_args == (plan.cluster, plan.rows, plan.tiles,
                                plan.groups, plan.resident, plan.stages,
                                plan.pieces, plan.smem_bytes)


@pytest.mark.parametrize("hsz", [128, 384, 512])
def test_wide_bwd_layout_is_the_source(hsz):
    """The planner's plans at the training row counts (stub occupancy): the
    shared bytes are the source's layout (the h tile, the second product's
    ring of dgates pieces and W_hh rows, the recompute's ring and resident
    k-pairs, the cell's operands and the mbarriers), within SMEM_LIMIT,
    for the plan and for every resident count and ring it could have."""
    for rows in TRAIN_ROWS + (18,):
        plan = tl.plan_bwd_wide(hsz, rows, stub_wide_bwd_occupancy)
        _check_plan(plan, hsz, rows)
        for pieces in (1, 4):
            for stages in (0, 1, 3):
                top = plan.hidden // 16 - (2 if stages else 0)
                for resident in range(0 if stages else top, top + 1, 2):
                    assert tl.bwd_wide_smem_bytes(
                        plan.hidden, plan.cluster, plan.rows, resident,
                        stages, pieces) == _source_smem(
                            plan.hidden, plan.cluster, plan.rows, resident,
                            stages, pieces)
    # the h tile and the pieces are 1024-byte aligned swizzled boxes
    assert tl.bwd_wide_smem_bytes(384, 8, 80, 0, 4, 4) == 231072


@pytest.mark.parametrize("rows", TRAIN_ROWS)
def test_plans_at_the_training_rows(rows):
    """At FullSubNet+'s sub-band training batch (2304 rows, 2295 ragged)
    and the NPPC head's 1024 rows the plan is a valid layout whose modelled
    waves x step no plan of the same cluster size with one more or one
    fewer m16 tile a cluster beats; at 2304 rows two or three waves of C=8
    clusters, where the resident cluster needs ten."""
    plan = tl.plan_bwd_wide(384, rows, stub_wide_bwd_occupancy)
    _check_plan(plan, 384, rows)
    best = plan.waves * plan.step_us
    for other in (plan.rows - 16, plan.rows + 16):
        if other < 16:
            continue
        for tiles, groups in tl.BWD_WIDE_ITEMS:
            units = plan.hidden // plan.cluster
            if (other % (16 * tiles) or units // 8 % groups
                    or tl.bwd_wide_items(plan.hidden, plan.cluster, other,
                                         tiles, groups)
                    > tl._BWD_WIDE_MAX_ITEMS[tiles, groups]):
                continue
            for pieces in tl.BWD_WIDE_STAGES:
                for stages in (0, *tl.STREAM_STAGES):
                    res = tl._bwd_wide_resident(plan.hidden, plan.cluster,
                                                other, stages, pieces, None)
                    if res is None or (stages and stages >
                                       plan.hidden // 32 - res // 2):
                        continue
                    waves = -(-(-(-rows // other)) // _h100(plan.cluster,
                                                            other))
                    assert best <= waves * tl.bwd_wide_step_us(
                        plan.hidden, plan.cluster, other, tiles, groups, res,
                        stages, pieces)
    if rows in (2304, 2295):
        assert (plan.cluster, plan.rows, plan.tiles, plan.groups,
                plan.clusters, plan.waves) == (8, 80, 1, 3, 29, 2)
        with tl.resident_backwards():
            resident = tl.plan_bwd_scan(384, rows, _h100)
        assert resident.design == "cluster" and resident.waves == 10
    else:
        assert (plan.cluster, plan.rows, plan.clusters, plan.waves) == (
            8, 80, 13, 1)


def test_full_band_stays_resident():
    """At the full band (H=512 x 18 rows, and one row) the resident
    cluster models faster than the wide one, so the plan is unchanged."""
    for rows in (18, 1):
        plan = tl.plan_bwd_scan(512, rows, _h100)
        wide = tl.plan_bwd_wide(512, rows, stub_wide_bwd_occupancy)
        assert plan.design == "cluster" and (plan.cluster, plan.rows) == (
            16, 16)
        assert plan.waves * plan.step_us < wide.waves * wide.step_us


def test_refusals_name_the_bytes():
    """Where no CTA holds a whole item within its warps and shared memory,
    nor a TMA box of its units, the planner raises naming each cluster
    size's units, or its bytes and items; a plan that is not the entry's
    BwdWidePlan at the H given is refused before anything launches, and
    the resident entry refuses a wide plan."""
    with pytest.raises(ValueError, match=r"no wide plan for the LSTM backward "
                                         r"scan at H=4096, 18 rows: C=8: 512 "
                                         r"units a CTA.*C=16: \d+ B and 16 "
                                         r"items at 16 rows"):
        tl.plan_bwd_wide(4096, 18, stub_wide_bwd_occupancy)
    with pytest.raises(ValueError, match=r"C=16: 8 units a CTA \(whole items "
                                         r"of \[2, 3\] 8-unit groups"):
        tl.plan_bwd_wide(64, 18, stub_wide_bwd_occupancy)
    with pytest.raises(ValueError, match="at least one row"):
        tl.plan_bwd_wide(384, 0, stub_wide_bwd_occupancy)
    with pytest.raises(ValueError, match="no wide plan.*the card runs no"):
        tl.plan_bwd_wide(384, 18, lambda *a: 0)
    plan = tl.plan_bwd_wide(384, 40, stub_wide_bwd_occupancy)
    x = torch.zeros(2, 16)
    for bad in (None, tl.plan_bwd_scan(384, 40, _h100),
                tl.plan_bwd_wide(512, 40, stub_wide_bwd_occupancy)):
        with pytest.raises(ValueError, match="BwdWidePlan its weight was "
                                             "packed for, at H=384"):
            tl._launch("lstm_scan_bwd_wide", x, x, x, x, x, x, x, 5, 40, 384,
                       0, plan=bad)
    with pytest.raises(ValueError, match="lstm_scan_bwd launches with a "
                                         "BwdPlan, got BwdWidePlan"):
        tl._launch("lstm_scan_bwd", x, x, x, x, x, x, x, x, 5, 40, 384, 0,
                   plan=plan)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_launch_kernel", lambda *a: seen.append(a))
        tl._launch("lstm_scan_bwd_wide", x, x, x, x, x, x, x, 5, 40, 384, 0,
                   plan=plan)
    assert seen == [("lstm_scan_bwd_wide", x, x, x, x, x, x, x, 5, 40, 384,
                     0, *plan.launch_args)]


def test_sources_declare_their_entries():
    """Without a compiler: the entry and its traced twin take the arguments
    ops/_cuda.py declares, ending in the plan (and the trace) and the
    stream, the occupancy query its instance flags, the entries refuse
    bytes that are not the layout's, and the launch counts know the
    entry."""
    text = (_cuda.CSRC / SOURCE).read_text()
    tail = ["reverse", "cluster", "rows", "tiles", "groups", "resident",
            "stages1", "stages2", "smem_bytes"]
    sigs = _cuda._SIGNATURES["lstm_scan_bwd_wide"]
    assert set(sigs) == {"lstm_scan_bwd_wide", "lstm_scan_bwd_wide_trace"}
    for name, argtypes in sigs.items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        end = ["trace", "stream"] if name.endswith("_trace") else ["stream"]
        assert len(names) == len(argtypes) and names[-len(tail) - len(end):] \
            == tail + end
    assert tl._SOURCE_OF["lstm_scan_bwd_wide"] == "lstm_scan_bwd_wide"
    assert "lstm_scan_bwd_wide" in tl.launch_counts
    query = re.search(r"\bint lstm_scan_bwd_wide_max_clusters\(([^)]*)\)",
                      text)
    assert " ".join(query.group(1).split()) == (
        "int tiles, int groups, int resident, int stages1, int stages2, "
        "int H, int cluster, int rows, int* n")
    assert len(_cuda._QUERIES["lstm_scan_bwd_wide"][
        "lstm_scan_bwd_wide_max_clusters"]) == 9
    for tiles, groups in tl.BWD_WIDE_ITEMS:
        assert f"WIDE_BWD_ITEM({tiles}, {groups})" in text
    assert ("smem_bytes != wide_bwd_smem(H, C, R, resident, stages1, "
            "stages2)") in text
    assert "lstm_scan_bwd_wide" in _cuda.SOURCES


# one-cluster steps (us) measured on an H100 SXM at 700 W, T=195
# (generative_audio_torch/scripts/perf_bwd_scan.py --wide): (H, C, R,
# tiles, groups, resident k-steps, stages, pieces)
MEASURED_STEPS = {(384, 8, 80, 1, 3, 0, 3, 4): 20.194,
                  (384, 8, 80, 1, 3, 2, 3, 4): 19.949,
                  (384, 16, 80, 1, 3, 24, 0, 4): 14.889,
                  (512, 16, 48, 1, 2, 22, 3, 4): 14.824,
                  (512, 8, 48, 1, 2, 0, 3, 1): 31.206}


def test_step_model_fits_the_sweep():
    """_BWD_WIDE_PARTS reproduces the sweep's steps within the fit's
    largest error over its 238 plans (4.09 us a step)."""
    for plan, us in MEASURED_STEPS.items():
        assert tl.bwd_wide_step_us(*plan) == pytest.approx(us, abs=4.09)


def test_step_model():
    """The wide step grows with the rows and with the item (its warp's
    products); streamed k-pairs and shallower rings cost no less."""
    base = tl.bwd_wide_step_us(384, 8, 80, 1, 3, 0, 4, 4)
    assert tl.bwd_wide_step_us(384, 8, 64, 1, 3, 0, 4, 4) < base
    assert tl.bwd_wide_step_us(384, 8, 80, 1, 3, 4, 4, 4) <= base
    assert tl.bwd_wide_step_us(384, 8, 80, 1, 3, 0, 1, 4) >= base
    assert tl.bwd_wide_step_us(384, 8, 80, 1, 3, 0, 4, 1) >= base
    assert tl.bwd_wide_step_us(384, 8, 96, 2, 3, 0, 4, 4) > \
        tl.bwd_wide_step_us(384, 8, 96, 1, 3, 0, 4, 4)


def _modelled_resident(hsz, rows):
    with tl.resident_backwards():
        plan = tl.plan_bwd_scan(hsz, rows, _h100)
    return plan.waves * plan.step_us


@pytest.mark.parametrize("hsz", [384, 512])
def test_route_weighs_wide_against_resident(hsz):
    """plan_bwd_scan takes the wide cluster where its modelled waves x step
    beat the resident cluster's (and the single block's), at every row
    count, and else keeps the resident plan; the GRU's plan weighs its own
    wide cluster the same way (tests/test_torch_gru_wide_bwd.py)."""
    for rows in TRAIN_ROWS + (1, 18, 257, 2056):
        wide = tl.plan_bwd_wide(hsz, rows, stub_wide_bwd_occupancy)
        with tl.resident_backwards():
            resident = tl.plan_bwd_scan(hsz, rows, _h100)
        got = tl.plan_bwd_scan(hsz, rows, _h100)
        if wide.waves * wide.step_us < resident.waves * resident.step_us:
            assert got == wide, rows
        else:
            assert got == resident, rows
        gru_wide = tg.plan_bwd_wide_scan(hsz, rows, stub_wide_bwd_occupancy)
        assert tg.plan_bwd_scan(hsz, rows, _h100) != wide
        assert tg.plan_bwd_scan(hsz, rows, _h100).design in (
            "cluster", "block", "wide")
        if tg.plan_bwd_scan(hsz, rows, _h100).design == "wide":
            assert tg.plan_bwd_scan(hsz, rows, _h100) == gru_wide
    assert tl.plan_bwd_scan(384, 2304, _h100).design == "wide"


def test_context_managers_force_their_design():
    """wide_backwards() forces the wide plan at any row count (18 rows
    too), resident_backwards() the plan without it; the innermost wins, the
    GRU's plan is forced alike (its own wide plan), kernel G's is
    untouched, and the forwards' context managers move no backward."""
    assert tl.plan_bwd_scan(384, 18, _h100).design == "cluster"
    with tl.wide_backwards():
        for rows in (1, 18, 2304):
            assert tl.plan_bwd_scan(384, rows, _h100) == tl.plan_bwd_wide(
                384, rows, stub_wide_bwd_occupancy)
        assert tg.plan_bwd_scan(384, 18, _h100) == tg.plan_bwd_wide_scan(
            384, 18, stub_wide_bwd_occupancy)
        with tl.resident_backwards():
            assert tl.plan_bwd_scan(384, 2304, _h100).design == "cluster"
        assert tl.plan_bwd_scan(384, 2304, _h100).design == "wide"
    with tl.resident_forwards():
        assert tl.plan_bwd_scan(384, 2304, _h100).design == "wide"
    with tl.wide_forwards():
        assert tl.plan_bwd_scan(384, 18, _h100).design == "cluster"
    assert tl.plan_chains_scan(384, 2304, 2,
                               lambda c, r, *rest: 15).chains == 2


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch
    recorded and the backward plans from the stub occupancy."""
    calls = []
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    stub_bwd_plans(monkeypatch)
    return calls


def _operands(t_len, b, hsz, seed):
    gates = torch.from_numpy(_rand((t_len, b, 4 * hsz), seed)).to(
        torch.bfloat16)
    h_seq, c_seq, gout = (torch.from_numpy(_rand((t_len, b, hsz), seed + i))
                          .to(torch.bfloat16) for i in (1, 2, 3))
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), seed + 4, 0.1))
    return gates, h_seq, c_seq, gout, w_hh


def test_wrappers_hand_the_entry_its_plan(recorded, monkeypatch):
    """lstm_scan_bwd_tm at 2304 rows of H=384: on CPU tensors, with no
    card's occupancy, the resident entry (its plan asked at launch), within
    wide_backwards() and on a (stubbed) card one launch of the wide entry
    whose arguments are the wrapper's operands (W_hh packed twice in
    fragment order for the plan's cluster) and end in the plan;
    lstm_scan_bwd_planned_tm launches a given wide plan the same way."""
    t_len, b, hsz = 2, 2304, 384
    ops = _operands(t_len, b, hsz, 7)
    plan = tl.plan_bwd_wide(hsz, b, lambda h, c, r, *a: _h100(c, r))
    tl.lstm_scan_bwd_tm(*ops, reverse=True)
    with tl.wide_backwards():
        tl.lstm_scan_bwd_tm(*ops, reverse=True)
    monkeypatch.setattr(tl, "_on_card", lambda device: True)
    tl.lstm_scan_bwd_tm(*ops, reverse=True)
    tl.lstm_scan_bwd_planned_tm(*ops, plan, reverse=True)
    assert [name for name, _ in recorded] == ["lstm_scan_bwd"] + [
        "lstm_scan_bwd_wide"] * 3
    resident = tl.plan_bwd_scan(hsz, b, _h100)
    with tl.resident_backwards():
        resident = tl.plan_bwd_scan(hsz, b, _h100)
    assert recorded[0][1][-8:] == (t_len, b, hsz, 1, *resident.launch_args)
    for _, args in recorded[1:]:
        assert args[-12:] == (t_len, b, hsz, 1, *plan.launch_args)
        assert args[0] is ops[0] and args[1] is ops[1]
        assert torch.equal(stream_weight_rows(args[4], plan, 4),
                           tl._kernel_weight(ops[4]))
        assert torch.equal(stream_dh_weight_rows(args[5], plan, 4),
                           tl._padded_weight(ops[4], hsz))
        assert args[6].shape == (t_len, b, 4 * hsz)
        assert args[6].dtype == torch.bfloat16


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fake launch
    of tests/test_torch_lstm_backward.py and the backward plans from the
    stub occupancy."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
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
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        return fn()


@pytest.mark.parametrize("hsz", [100, 128])
def test_kernel_branch_equals_the_cpu_branch(launches, hsz):
    """At H=100 (padded to the wide cluster's units) and 128 over 40 rows
    under wide_backwards(): one lstm_scan_bwd_wide a call, forward and
    reverse, equal to the CPU branch; LSTMScan's gradients (one training
    forward, one wide backward) equal the CPU branch's."""
    ops = _operands(5, 40, hsz, hsz)
    for reverse in (False, True):
        with tl.wide_backwards():
            got = _counted(launches, {"lstm_scan_bwd_wide": 1},
                           lambda: tl.lstm_scan_bwd_tm(*ops, reverse))
        want = _on_cpu(lambda: tl.lstm_scan_bwd_tm(*ops, reverse))
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)

        def grads():
            g = ops[0].float().requires_grad_()
            w = ops[4].clone().requires_grad_()
            (tl.lstm_scan_tm(g, w, reverse, torch.float32) ** 2).sum(
            ).backward()
            return g.grad, w.grad

        with tl.wide_backwards():
            got = _counted(launches, {"lstm_scan_fwd_train": 1,
                                      "lstm_scan_bwd_wide": 1}, grads)
        for a, b in zip(got, _on_cpu(grads)):
            assert torch.equal(a, b)


def _pallas_grads(gx, whh, ct, reverse):
    """dgates and dW_hh of the JAX lstm_scan_tm's custom VJP, whose
    backward is _lstm_pallas_call_bwd in interpret mode (dW_hh as its one
    contraction)."""
    _, vjp = jax.vjp(lambda g, w: jl.lstm_scan_tm(g, w, reverse, 576, True,
                                                  jnp.float32), gx, whh)
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_pallas_interpret(launches, reverse):
    """LSTMScan on the wide branch (wide_backwards()) at H=128 x 40 rows x
    T=8, dgates and dW_hh for a random cotangent, against the JAX package's
    lstm_scan_tm, whose backward runs _lstm_pallas_call_bwd in interpret
    mode; one wide backward launch."""
    hsz = 128
    gx = _rand((8, 40, 4 * hsz), 51)
    whh = _rand((hsz, 4 * hsz), 52, 0.1)
    ct = _rand((8, 40, hsz), 53)
    want_dg, want_dw = _pallas_grads(jnp.asarray(gx, jnp.bfloat16), whh, ct,
                                     reverse)

    def grads():
        g = torch.from_numpy(gx).to(torch.bfloat16).requires_grad_()
        w = torch.from_numpy(whh).requires_grad_()
        y = tl.lstm_scan_tm(g, w, reverse, torch.float32)
        (y * torch.from_numpy(ct)).sum().backward()
        return g.grad.float().numpy(), w.grad.numpy()

    with tl.wide_backwards():
        got_dg, got_dw = _counted(launches, {"lstm_scan_fwd_train": 1,
                                             "lstm_scan_bwd_wide": 1}, grads)
    np.testing.assert_allclose(got_dg, want_dg, **BF16)
    np.testing.assert_allclose(got_dw, want_dw, rtol=1e-2,
                               atol=1e-2 * np.abs(want_dw).max())
