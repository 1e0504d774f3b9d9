"""Kernel C as a wide cluster (csrc/lstm_scan_wide.cu
`lstm_scan_fwd_train_wide`: kernel A's wide cluster, each step's product on
warpgroup MMA (wgmma), that also stores the bf16 c sequence from the
registers that hold c; the route of `lstm_scan_train_tm`, and so of
LSTMScan's forward, where its model beats the resident cluster's) on the
CPU: the training layout against the source (the shared bytes of kernel
A's layout, the entry's refusals), its plans at the training row counts
over the card's occupancy (tests/torch_stream_stubs.py), the route between
the wide and the resident cluster for kernel C and the two context
managers that force one, the plan and packed weight the wrapper hands the
entry (a recording fake of `_launch_kernel`), the kernel branch (the fake
launch of tests/test_torch_lstm_backward.py, which unpacks the packed W_hh^T
and runs the plain version) against the CPU branch, LSTMScan's gradients
through the wide route, and the wrapper against the JAX package's Pallas
training kernel in interpret mode at a small H. No JAX model is built.

The tolerances: the layout and plan checks are exact; the kernel branch
equals the CPU branch bit for bit (the fake computes the plain version on
the real units, which the padded units leave unchanged); against Pallas the
bf16 ones, 1e-2 absolute and relative, as tests/test_torch_wide_scan.py
states them: both sides compute the same bf16 algorithm and differ in the
order of the sums and in the transcendental functions, and a float32
difference that crosses a bf16 rounding boundary moves h or c by one bf16
step (2^-8 relative) for the next product.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import lstm as tl
from test_torch_lstm_backward import fake_launch
from test_torch_wide_scan import SOURCE, _check_plan, _source_smem
from torch_stream_stubs import card_wide_occupancy, stub_bwd_plans
from torch_stream_stubs import stub_occupancy, stub_stream_plans
from torch_stream_stubs import stub_wide_occupancy
from torch_stream_stubs import stub_wide_route, wide_weight_rows

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
CPU = torch.device("cpu")
ENTRY = "lstm_scan_fwd_train_wide"
TRAIN = (0, 0, 1)          # _forward_route's instance of kernel C
# (H, rows) of the training shapes: FullSubNet+'s sub-band batch (18 x
# 3.072 s x 128 bands), a ragged count, the NPPC head's 1024 rows and the
# full band's 18 rows at H=512.
TRAIN_SHAPES = ((384, 2304), (384, 2295), (384, 1024), (512, 18))


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _resident(hsz, rows, occupancy=card_wide_occupancy):
    plan = tl.plan_scan(hsz, rows, lambda c, r: occupancy(hsz, c, r, 0, 1))
    return plan, plan.waves * tl.scan_step_us(hsz, plan.cluster, plan.rows)


def _entry_body(name):
    text = (_cuda.CSRC / SOURCE).read_text()
    return re.search(rf"\bint {name}\([^)]*\) \{{(.*?)\n\}}", text,
                     re.S).group(1)


def _stub_card_plans(monkeypatch, occupancy=card_wide_occupancy):
    """card_wide_plan and card_scan_plan from `occupancy`, the route
    weighing them for CPU tensors as on a card; returns the arguments each
    was asked with."""
    asked = {"wide": [], "resident": []}
    monkeypatch.setattr(
        tl, "card_wide_plan",
        lambda device, hsz, batch, resident=None: asked["wide"].append(
            (hsz, batch, resident)) or tl.plan_wide_scan(hsz, batch,
                                                         occupancy, resident))
    monkeypatch.setattr(
        tl, "card_scan_plan",
        lambda device, hsz, batch, out_dtype=torch.bfloat16, carry=False,
        train=False: asked["resident"].append(
            (hsz, batch, out_dtype, carry, train)) or tl.plan_scan(
            hsz, batch, lambda c, r: occupancy(hsz, c, r, 0, 1)))
    monkeypatch.setattr(tl, "_on_card", lambda device: True)
    return asked


@pytest.mark.parametrize("hsz,rows", TRAIN_SHAPES)
def test_training_layout_is_kernel_as(hsz, rows):
    """Kernel C stores c from registers, so its shared bytes are kernel A's
    layout: the planner's bytes for the training plans are the source's
    wide_smem, the entry goes through the same check of the bytes
    (dispatch) with bf16 h and its c sequence, and refuses a missing c
    sequence; the kernel stores c once a step from the register that holds
    it, rounded to bf16 once."""
    plan = tl.plan_wide_scan(hsz, rows, card_wide_occupancy)
    _check_plan(plan, hsz, rows)
    assert plan.smem_bytes == _source_smem(plan.hidden, plan.cluster,
                                           plan.rows, plan.resident,
                                           plan.stages)
    body = " ".join(_entry_body(ENTRY).split())
    assert "if (c_seq == nullptr) return (int)cudaErrorInvalidValue;" in body
    assert ("return dispatch(0, 0, gates, wf, nullptr, nullptr, h_seq, "
            "c_seq, nullptr, nullptr, nullptr, T, B, H, reverse, cluster, "
            "rows, resident, stages, (size_t)smem_bytes, stream, nullptr);"
            in body)
    text = (_cuda.CSRC / SOURCE).read_text()
    assert "smem_bytes != wide_smem(H, C, R, resident, stages, 4)" in text
    assert text.count("c_seq[(size_t)t * B * Hs + o] = "
                      "__float2bfloat16(c);") == 1
    # the other entries hand the kernel no c sequence
    for name in ("lstm_scan_fwd_wide", "lstm_scan_fwd_carry_wide",
                 "lstm_scan_wide_trace"):
        call = " ".join(_entry_body(name).split())
        args = re.search(r"dispatch\((.*?)\);", call).group(1).split(", ")
        assert args[7] == "nullptr", name


@pytest.mark.parametrize("hsz,rows", TRAIN_SHAPES)
def test_training_plans_at_the_model_rows(hsz, rows):
    """Over the card's occupancy (15 clusters of 8 at once) the training
    batch's 2304 rows, and its ragged 2295, take one wave of 15 clusters of
    160 rows (three warpgroups a CTA) where the resident cluster needs
    five; the NPPC head's 1024 rows one wave of 13 clusters of 80 where the
    resident needs three; the full band's 18 rows at H=512 a cluster of 16
    (two warpgroups). At each the wide plan models faster than the
    resident one. Over stub_occupancy's 16 clusters 2304 rows take one wave
    of 144 rows."""
    plan = tl.plan_wide_scan(hsz, rows, card_wide_occupancy)
    _check_plan(plan, hsz, rows)
    resident, resident_us = _resident(hsz, rows)
    assert plan.waves * plan.step_us < resident_us
    want = {(384, 2304): (8, 160, 3, 15, 1, 5),
            (384, 2295): (8, 160, 3, 15, 1, 5),
            (384, 1024): (8, 80, 3, 13, 1, 3),
            (512, 18): (16, 16, 2, 2, 1, 1)}[(hsz, rows)]
    assert (plan.cluster, plan.rows, plan.warpgroups, plan.clusters,
            plan.waves, resident.waves) == want
    assert plan.stages != 1
    if rows == 2304:
        assert (plan.resident, plan.stages, plan.smem_bytes) == (0, 3, 221376)
        stub = tl.plan_wide_scan(hsz, rows, stub_wide_occupancy)
        assert (stub.rows, stub.clusters, stub.waves) == (144, 16, 1)


@pytest.mark.parametrize("rows", [1, 18, 257, 1024, 2295, 2304])
def test_route_weighs_wide_against_resident_for_c(rows, monkeypatch):
    """On a card (stubbed) kernel C takes the wide cluster where its
    modelled waves x step beat the resident training plan's (asked with the
    training flag), with the one wide plan kernels A and B take at those
    rows (asked alike); on CPU tensors, with no occupancy to weigh, the
    resident cluster."""
    assert tl._forward_route(384, rows, CPU, TRAIN) == (384, "", None)
    asked = _stub_card_plans(monkeypatch)
    wide = tl.plan_wide_scan(384, rows, card_wide_occupancy)
    faster = wide.waves * wide.step_us < _resident(384, rows)[1]
    got = tl._forward_route(384, rows, CPU, TRAIN)
    assert got == ((384, "_wide", wide) if faster else (384, "", None))
    assert asked["resident"] == [(384, rows, torch.bfloat16, False, True)]
    assert tl._forward_route(384, rows, CPU) == got
    assert asked["wide"] == [(384, rows, None)] * 2
    if rows >= 1024:
        assert faster
    if rows == 257:     # the models tie there; the resident keeps it
        assert not faster


def test_context_managers_force_kernel_c(monkeypatch):
    """wide_forwards() forces kernel C's wide cluster at any row count (on
    CPU tensors too), resident_forwards() its resident cluster where the
    route would take the wide one; the innermost wins, and
    single_block_forwards() and streamed_forwards() still win over both."""
    _stub_card_plans(monkeypatch)
    stub_stream_plans(monkeypatch)
    with tl.resident_forwards():
        assert tl._forward_route(384, 2304, CPU, TRAIN) == (384, "", None)
        with tl.wide_forwards():
            assert tl._forward_route(384, 2304, CPU, TRAIN)[1] == "_wide"
    monkeypatch.setattr(tl, "_on_card", lambda device: False)
    with tl.wide_forwards():
        for rows in (1, 257, 2304):
            assert tl._forward_route(384, rows, CPU, TRAIN) == (
                384, "_wide", tl.plan_wide_scan(384, rows,
                                                card_wide_occupancy))
        with tl.single_block_forwards():
            assert tl._forward_route(384, 18, CPU, TRAIN)[1] == "_block"
        with tl.streamed_forwards():
            assert tl._forward_route(384, 18, CPU, TRAIN)[1] == "_stream"
    assert tl._forward_route(384, 2304, CPU, TRAIN) == (384, "", None)


@pytest.mark.parametrize("reverse", [False, True])
def test_wrapper_hands_the_entry_its_plan(reverse, monkeypatch):
    """lstm_scan_train_tm on a (stubbed) card at the 2304 training rows of
    H=384, and LSTMScan's forward under grad: one launch of the wide entry
    each, whose arguments are the wrapper's operands (the gates as given,
    W_hh^T packed for wgmma for the plan's cluster, bf16 h_seq and c_seq)
    and end in (T, B, H, reverse) and the plan card_wide_plan gave; a plan
    that is not the entry's WidePlan at that H is refused before anything
    launches."""
    _stub_card_plans(monkeypatch)
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    calls = []
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    t_len, b, hsz = 2, 2304, 384
    gates = torch.zeros(t_len, b, 4 * hsz, dtype=torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), 7, 0.05))
    h_seq, c_seq = tl.lstm_scan_train_tm(gates, w_hh, reverse)
    tl.lstm_scan_tm(gates.float().requires_grad_(), w_hh, reverse)
    plan = tl.plan_wide_scan(hsz, b, card_wide_occupancy)
    assert [name for name, _ in calls] == [ENTRY, ENTRY]
    for i, (_, args) in enumerate(calls):
        assert args[-9:] == (t_len, b, hsz, reverse, *plan.launch_args)
        assert len(args) == len(_cuda._SIGNATURES["lstm_scan_wide"][ENTRY]) - 1
        assert args[0].dtype == torch.bfloat16 and torch.equal(args[0], gates)
        assert torch.equal(wide_weight_rows(args[1], plan),
                           tl._kernel_weight(w_hh))
        for out in args[2:4]:
            assert out.shape == (t_len, b, hsz) and out.dtype == torch.bfloat16
    assert calls[0][1][0] is gates
    assert calls[0][1][2] is h_seq and calls[0][1][3] is c_seq
    x = torch.zeros(2, 16)
    for bad in (None, tl.plan_stream_scan(384, 40, stub_occupancy),
                tl.plan_wide_scan(512, 40, card_wide_occupancy)):
        with pytest.raises(ValueError, match="WidePlan its weight was packed "
                                             "for, at H=384"):
            tl._launch(ENTRY, x, x, x, x, 5, 40, 384, 0, plan=bad)
    assert len(calls) == 2


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fake launch
    of tests/test_torch_lstm_backward.py and the wide plans from the card's
    occupancy (the route weighs nothing on CPU tensors: wide_forwards()
    forces the wide cluster)."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    monkeypatch.setattr(
        tl, "card_wide_plan", lambda device, hsz, batch, resident=None:
        tl.plan_wide_scan(hsz, batch, card_wide_occupancy, resident))
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
    under wide_forwards(): one lstm_scan_fwd_train_wide a call, forward and
    reverse, h_seq and c_seq equal to the CPU branch bit for bit, and h_seq
    equal to the wide kernel A's bf16 output."""
    gates = torch.from_numpy(_rand((9, 40, 4 * hsz), hsz)).to(torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), hsz + 1, 0.1))
    for reverse in (False, True):
        with tl.wide_forwards():
            h_seq, c_seq = _counted(
                launches, {ENTRY: 1},
                lambda: tl.lstm_scan_train_tm(gates, w_hh, reverse))
            with torch.no_grad():
                h_a = _counted(launches, {"lstm_scan_fwd_wide": 1},
                               lambda: tl.lstm_scan_tm(gates, w_hh, reverse))
        want_h, want_c = _on_cpu(lambda: tl.lstm_scan_train_tm(gates, w_hh,
                                                               reverse))
        for got, want in ((h_seq, want_h), (c_seq, want_c)):
            assert got.dtype == torch.bfloat16 and got.shape == (9, 40, hsz)
            assert torch.equal(got, want)
        assert torch.equal(h_seq, h_a)


def _grads(gates, w_hh, ct, reverse):
    g = gates.float().requires_grad_()
    w = w_hh.clone().requires_grad_()
    y = tl.lstm_scan_tm(g, w, reverse, torch.float32)
    (y * ct).sum().backward()
    return y, g.grad, w.grad


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_gradients_through_the_wide_route(launches, reverse,
                                                    monkeypatch):
    """LSTMScan at the training batch's 2304 rows (H=256, T=3) on a
    (stubbed) card: its forward takes kernel C's wide entry by the route,
    its backward kernel D's routed entry; h and both gradients equal the
    CPU branch's bit for bit."""
    stub_wide_route(monkeypatch)
    stub_bwd_plans(monkeypatch)
    monkeypatch.setattr(
        tl, "card_wide_plan", lambda device, hsz, batch, resident=None:
        tl.plan_wide_scan(hsz, batch, card_wide_occupancy, resident))
    hsz, rows = 256, 2304
    assert tl._forward_route(hsz, rows, CPU, TRAIN)[1] == "_wide"
    gates = torch.from_numpy(_rand((3, rows, 4 * hsz), 61)).to(torch.bfloat16)
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), 62, 0.1))
    ct = torch.from_numpy(_rand((3, rows, hsz), 63))
    d_entry = "lstm_scan_bwd" + (
        "_wide" if tl.card_bwd_scan_plan(CPU, hsz, rows).design == "wide"
        else "")
    got = _counted(launches, {ENTRY: 1, d_entry: 1},
                   lambda: _grads(gates, w_hh, ct, reverse))
    for a, b in zip(got, _on_cpu(lambda: _grads(gates, w_hh, ct, reverse))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
def test_train_forward_matches_pallas_interpret(launches, reverse):
    """lstm_scan_train_tm on the wide branch (wide_forwards()) at H=128 x
    40 rows x T=12 against the JAX package's training kernel
    (_lstm_pallas_call_train) in interpret mode, 48 rows a block (the
    batch zero-padded): h_seq and c_seq within the bf16 tolerance."""
    hsz, b, block = 128, 40, 48
    gx, whh = _rand((12, b, 4 * hsz), 71), _rand((hsz, 4 * hsz), 72, 0.08)
    gates = jnp.asarray(np.pad(gx, ((0, 0), (0, block - b), (0, 0))),
                        jnp.bfloat16)
    want_h, want_c = jl._lstm_pallas_call_train(
        gates, jnp.asarray(whh), block_b=block, interpret=True,
        reverse=reverse)
    tgates = torch.from_numpy(np.array(gates[:, :b].astype(jnp.float32))
                              ).to(torch.bfloat16)
    with tl.wide_forwards():
        h_seq, c_seq = _counted(
            launches, {ENTRY: 1},
            lambda: tl.lstm_scan_train_tm(tgates, torch.from_numpy(whh),
                                          reverse))
    for got, want in ((h_seq, want_h), (c_seq, want_c)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32))[:, :b],
            **BF16)
