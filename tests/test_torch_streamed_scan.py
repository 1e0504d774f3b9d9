"""The streamed cluster forwards of kernels A, B, C and of the GRU forward
(csrc/lstm_scan.cu and csrc/gru_scan.cu, entries ending in `_stream`) on
the CPU: their layouts against the sources, the planner and the route of a
forward (ops/lstm.py plan_stream, plan_forward, streamed_forwards), the
packed W_hh operand, the wrappers' kernel branch (launches faked by
tests/test_torch_lstm_backward.py and tests/test_torch_gru.py, which unpack
the operand and run the plain versions) against their CPU branch and the
JAX package's Pallas kernels in interpret mode, and a FullSubNet+ whose
sub-band LSTM no resident cluster holds (sb_model_hidden_size=640) against
the JAX model.

The tolerances: the kernel branch equals the CPU branch bit for bit (the
fakes compute the plain versions on the real units); against Pallas, the
bf16 ones of tests/test_torch_padded_hidden.py (a float32 difference that
crosses a bf16 rounding boundary moves h by one bf16 step); the model in
float32 on both sides at 1e-4 of the output's peak (float32 sums in
another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.models import (
    FullSubNetPlus as JaxFullSubNetPlus,
    FullSubNetPlusConfig as JaxFullSubNetPlusConfig)
from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.models import FullSubNetPlus, FullSubNetPlusConfig
from generative_audio_torch.nn import recurrent as R
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from test_torch_gru import fake_launch as gru_fake_launch
from test_torch_lstm_backward import fake_launch as lstm_fake_launch
from torch_stream_stubs import stream_weight_rows, stub_occupancy
from torch_stream_stubs import stub_stream_plans
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
KINDS = {"lstm": (tl, "lstm_scan.cu", 4), "gru": (tg, "gru_scan.cu", 3)}
LAYOUT_HIDDEN = [("lstm", h) for h in (640, 768, 1024, 1536, 1808)] + [
    ("gru", h) for h in (768, 1024, 1536)]
ROWS = (1, 18, 2056)
BF16 = dict(atol=1e-2, rtol=1e-2)
H_ATOL = 5e-3                     # GRU h, as tests/test_torch_gru.py
CPU = torch.device("cpu")


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


def _source_stream_smem(kind, hsz, cluster, rows, resident, stages):
    """stream_smem of the kernel's source, evaluated (stream_pair_bytes
    from the same source)."""
    _, source, _ = KINDS[kind]
    text = (_cuda.CSRC / source).read_text()
    pair = re.search(r"inline size_t stream_pair_bytes\(int U, int n_gates\) "
                     r"\{\s*return (.*?);\s*\}", text, re.S).group(1)
    body = re.search(r"size_t stream_smem\(int H, int C, int R, int resident, "
                     r"int stages\) \{(.*?)\n\}", text, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = " ".join(expr.split()).replace("/", "//")
    expr = re.sub(r"\(size_t\)", "", expr)
    pair = " ".join(pair.split()).replace("(size_t)", "")
    units = hsz // cluster
    env = dict(U=units, hs=hsz + 8, r=rows, R=rows, C=cluster, H=hsz,
               resident=resident, stages=stages)
    env["stream_pair_bytes"] = lambda u, n: eval(pair, {}, dict(U=u,
                                                                n_gates=n))
    return eval(expr, {}, env)


@pytest.mark.parametrize("kind,hsz", LAYOUT_HIDDEN)
def test_stream_layout_is_the_source_and_fits(kind, hsz):
    """The planner's plans at 1, 18 and 2056 rows (stub occupancy): the
    shared bytes are the source's layout, within SMEM_LIMIT, with at least
    one k-pair streamed and no deeper ring than the streamed k-pairs, at H
    padded to whole 8-unit groups of each CTA and whole k-pairs; forcing
    each resident count of the plan's shape gives the source's bytes too."""
    module = KINDS[kind][0]
    for rows in ROWS:
        plan = module.plan_stream_scan(hsz, rows, stub_occupancy)
        hp = plan.hidden
        assert hp == tl.stream_hidden(hsz, plan.cluster) >= hsz
        assert hp % (8 * plan.cluster) == 0 and hp % 32 == 0
        assert plan.smem_bytes <= tl.SMEM_LIMIT and plan.smem_bytes % 8 == 0
        assert plan.smem_bytes == module.stream_smem_bytes(
            hp, plan.cluster, plan.rows, plan.resident, plan.stages)
        assert plan.smem_bytes == _source_stream_smem(
            kind, hp, plan.cluster, plan.rows, plan.resident, plan.stages)
        assert plan.resident % 2 == 0 and plan.resident < hp // 16
        assert 1 <= plan.stages <= hp // 32 - plan.resident // 2
        assert plan.rows // 16 * (hp // plan.cluster // 8) <= 18
        assert plan.clusters == -(-rows // plan.rows)
        assert plan.waves == -(-plan.clusters // plan.active)
        assert plan.launch_args == (plan.cluster, plan.rows, plan.resident,
                                    plan.stages, plan.smem_bytes)
        for resident in range(0, plan.resident + 1, 2):
            assert module.stream_smem_bytes(
                hp, plan.cluster, plan.rows, resident, plan.stages
            ) == _source_stream_smem(kind, hp, plan.cluster, plan.rows,
                                     resident, plan.stages)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_planner_keeps_the_most_resident_that_fits(kind):
    """At H=768 and 18 rows: one more resident k-pair than the plan's would
    overflow SMEM_LIMIT; a forced resident count is kept, one that does not
    fit or leaves nothing to stream raises; a card that runs no such
    cluster leaves no plan."""
    module = KINDS[kind][0]
    plan = module.plan_stream_scan(768, 18, stub_occupancy)
    assert module.stream_smem_bytes(
        768, plan.cluster, plan.rows, plan.resident + 2, plan.stages
    ) > tl.SMEM_LIMIT
    forced = module.plan_stream_scan(768, 18, stub_occupancy, resident=4)
    assert forced.resident == 4
    with pytest.raises(ValueError, match="no streamed plan"):
        module.plan_stream_scan(768, 18, stub_occupancy, resident=48)
    with pytest.raises(ValueError, match="no streamed plan"):
        module.plan_stream_scan(768, 18, lambda *a: 0)


def test_step_models():
    """The modelled step grows with the streamed k-pairs and rows, and a
    ring of one stage waits a copy's whole latency for each k-pair."""
    for module in (tl, tg):
        base = module.stream_step_us(768, 16, 16, 16, 4)
        assert module.stream_step_us(768, 16, 16, 8, 4) > base
        assert module.stream_step_us(768, 16, 32, 16, 4) > base
        assert module.stream_step_us(768, 16, 16, 16, 1) > base
        assert module.block_step_us(768, 129) >= module.block_step_us(768, 2)


@pytest.mark.parametrize("kind,hsz,resident_hp", [
    ("lstm", 384, 384), ("lstm", 512, 512), ("lstm", 640, None),
    ("lstm", 1000, None), ("gru", 640, 640), ("gru", 768, None),
    ("gru", 1024, None)])
def test_route_weighs_the_designs(kind, hsz, resident_hp, monkeypatch):
    """_forward_route with a stub occupancy: the resident cluster where it
    holds H, no question asked of the card; else the streamed cluster,
    whose modelled waves x step beat the single block's at 18 rows; the
    single block where its model wins (a stand-in model) or where no
    streamed plan fits."""
    module = KINDS[kind][0]
    asked = []

    def card_stream_plan(device, h, batch, instance, resident):
        asked.append((h, batch, instance, resident))
        return module.plan_stream_scan(h, batch, stub_occupancy, resident)

    monkeypatch.setattr(module, "card_stream_plan", card_stream_plan)
    hp, suffix, plan = module._forward_route(hsz, 18, CPU)
    if resident_hp:
        assert (hp, suffix, plan) == (resident_hp, "", None) and not asked
        return
    assert suffix == "_stream" and hp == plan.hidden and asked
    block_hp = -(-hsz // 16) * 16
    block_us = module.block_step_us(block_hp, 2)
    assert plan.waves * plan.step_us < block_us
    monkeypatch.setattr(module, "block_step_us", lambda h, blocks: 1.0)
    assert module._forward_route(hsz, 18, CPU) == (block_hp, "_block", None)
    monkeypatch.setattr(module, "card_stream_plan", lambda *a: (_ for _ in (
        )).throw(ValueError("no streamed plan")))
    assert module._forward_route(hsz, 18, CPU) == (block_hp, "_block", None)


def test_plan_forward_refuses_what_nothing_holds():
    def no_plan(resident):
        raise ValueError("no streamed plan for the test")

    with pytest.raises(ValueError, match="no forward for the LSTM scan"):
        tl.plan_forward("LSTM", 2000, 18, tl.scan_smem_bytes,
                        tl.block_smem_bytes, tl.block_step_us, no_plan)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forcing_contexts(kind, monkeypatch):
    """streamed_forwards() takes the streamed cluster where the resident
    cluster holds H too (H=384), with the planner's or the given resident
    k-steps; single_block_forwards() the single block; after either the
    route is the resident cluster's again. Kernels E and F take the same
    forced route (their streamed clusters since they have one)."""
    module = KINDS[kind][0]
    stub_stream_plans(monkeypatch)
    assert module._forward_route(384, 18, CPU) == (384, "", None)
    with tl.streamed_forwards():
        hp, suffix, plan = module._forward_route(384, 18, CPU)
        assert (hp, suffix) == (384, "_stream") and plan.resident > 0
        assert tl.unrolled_route(384, 2)[:2] == (384, "_stream")
        assert tl.layer_route(384, 34)[:2] == (384, "_stream")
    with tl.streamed_forwards(resident_ksteps=8):
        assert module._forward_route(384, 18, CPU)[2].resident == 8
        with tl.streamed_forwards(resident_ksteps=0):
            assert module._forward_route(384, 18, CPU)[2].resident == 0
        assert module._forward_route(384, 18, CPU)[2].resident == 8
    with tl.single_block_forwards():
        assert module._forward_route(384, 18, CPU) == (384, "_block", None)
    assert module._forward_route(384, 18, CPU) == (384, "", None)


def test_e_and_f_routes_unchanged():
    """Kernels E and F take plan_forward's scheme as kernels A-C do: the
    cluster up to H=512, above it their streamed clusters
    (csrc/lstm_staged_stream.cu), whose modelled waves x step beat their
    single blocks', at H padded to stream_hidden's units; their single
    blocks, at H padded to 16, within single_block_forwards()."""
    for k in tl.UNROLL_STEPS:
        assert tl.unrolled_route(512, k) == (512, "", None)
        hp, suffix, plan = tl.unrolled_route(640, k)
        assert (hp, suffix) == (640, "_stream") and plan.hidden == 640
        with tl.single_block_forwards():
            assert tl.unrolled_route(640, k) == (640, "_block", None)
    assert tl.layer_route(512, 34) == (512, "", None)
    assert tl.layer_route(768, 34)[:2] == (768, "_stream")
    hp, suffix, plan = tl.layer_route(1000, 384)
    assert suffix == "_stream" and hp == tl.stream_hidden(1000, plan.cluster)
    with tl.single_block_forwards():
        assert tl.layer_route(768, 34) == (768, "_block", None)
        assert tl.layer_route(1000, 384) == (1008, "_block", None)


@pytest.mark.parametrize("kind,cluster,hp", [("lstm", 16, 256),
                                             ("lstm", 8, 128),
                                             ("gru", 16, 384)])
def test_stream_weight_is_fragment_ordered(kind, cluster, hp):
    """The packed operand: for CTA rank k, k-pair p, gate q, unit group g
    and lane (grp, tq), the 8 bf16 of (kk, half, e) are W_hh^T[q*hp + k*U +
    8g + grp, 32p + 16kk + 8half + 2tq + e]; and unpacking gives the kernel
    weight back (W_hh zero-padded from fewer units)."""
    n = KINDS[kind][2]
    hsz = hp - 8
    w_hh = torch.from_numpy(_rand((hsz, n * hsz), 5))
    wf = tl._stream_weight(w_hh, hp, cluster)
    wt = tl._kernel_weight(w_hh, hp)
    units = hp // cluster
    groups = units // 8
    assert wf.is_contiguous() and wf.dtype == torch.bfloat16
    assert tuple(wf.shape) == (cluster, hp // 32, n * groups, 8, 4, 2, 2, 2)
    rng = np.random.default_rng(6)
    for _ in range(200):
        k, p, q, g = (int(rng.integers(cluster)), int(rng.integers(hp // 32)),
                      int(rng.integers(n)), int(rng.integers(groups)))
        grp, tq, kk, half, e = (int(rng.integers(m)) for m in (8, 4, 2, 2, 2))
        assert wf[k, p, q * groups + g, grp, tq, kk, half, e] == wt[
            q * hp + k * units + 8 * g + grp,
            32 * p + 16 * kk + 8 * half + 2 * tq + e]
    plan = tl.StreamPlan(hp, cluster, 16, 0, 1, 1, 1, 1, 0, 0.0)
    assert torch.equal(stream_weight_rows(wf, plan, n), wt)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of both cells' wrappers on CPU tensors, with the
    fakes of the two test files and the streamed plans of a stub
    occupancy."""
    for mod, fake in ((tl, lstm_fake_launch), (tg, gru_fake_launch)):
        monkeypatch.setattr(mod, "_is_cuda", lambda *tensors: True)
        monkeypatch.setattr(mod, "_launch", fake)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


def _cpu(fn):
    """fn() on the CPU branch of both cells' wrappers."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tl, tg):
            mp.setattr(mod, "_is_cuda", lambda *tensors: False)
        return fn()


def _only(launches, **expect):
    return launches == {**dict.fromkeys(launches, 0), **expect}


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_stream_branch_equals_cpu_branch(launches, reverse):
    """At H=640 (no resident cluster; the streamed one at 640 units) and
    H=600 (padded to 640), 21 rows: forward, carry from a state and the
    training forward, each one launch of its `_stream` entry."""
    for hsz in (640, 600):
        gx, whh = _rand((4, 21, 4 * hsz), hsz), _rand((hsz, 4 * hsz), 1, 0.05)
        gates, w = _bf16(gx), torch.from_numpy(whh)
        h0 = torch.from_numpy(_rand((21, hsz), 2))
        c0 = torch.from_numpy(_rand((21, hsz), 3))

        def forward():
            with torch.no_grad():
                return (tl.lstm_scan_tm(gates, w, reverse, torch.float32),)

        def carry():
            return tl.lstm_scan_carry_tm(gates, w, h0, c0, reverse,
                                         torch.bfloat16)

        def train():
            return tl.lstm_scan_train_tm(gates, w, reverse)

        for fn, entry in ((forward, "lstm_scan_fwd_stream"),
                          (carry, "lstm_scan_fwd_carry_stream"),
                          (train, "lstm_scan_fwd_train_stream")):
            for k in launches:
                launches[k] = 0
            got = fn()
            assert _only(launches, **{entry: 1}), launches
            for a, b in zip(got, _cpu(fn)):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b), entry


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_stream_branch_equals_cpu_branch(launches, reverse):
    hsz = 768
    gx, whh = _rand((4, 9, 3 * hsz), 7), _rand((hsz, 3 * hsz), 8, 0.05)
    bhh = _rand((3 * hsz,), 9, 0.1)
    gates, w, b = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)
    h0 = torch.from_numpy(_rand((9, hsz), 10))

    def forward():
        with torch.no_grad():
            return (tg.gru_scan_tm(gates, w, b, reverse, torch.float32),)

    def carry():
        return tg.gru_scan_carry_tm(gates, w, b, h0, reverse, torch.float32)

    for fn, entry in ((forward, "gru_scan_fwd_stream"),
                      (carry, "gru_scan_fwd_carry_stream")):
        for k in launches:
            launches[k] = 0
        got = fn()
        assert _only(launches, **{entry: 1}), launches
        for a, b2 in zip(got, _cpu(fn)):
            assert a.dtype == b2.dtype and torch.equal(a, b2), entry


def test_lstm_stream_branch_matches_pallas_interpret(launches):
    """lstm_scan_tm at H=640 on the streamed branch against the JAX
    package's Pallas kernel in interpret mode."""
    hsz = 640
    gx, whh = _rand((3, 5, 4 * hsz), 11), _rand((hsz, 4 * hsz), 12, 0.05)
    want = np.asarray(jl.lstm_scan_tm(gx, whh, False, 576, True,
                                      jnp.float32))
    with torch.no_grad():
        got = tl.lstm_scan_tm(torch.from_numpy(gx), torch.from_numpy(whh),
                              False, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **BF16)
    assert _only(launches, lstm_scan_fwd_stream=1)


def test_gru_stream_branch_matches_pallas_interpret(launches):
    """gru_scan_tm at H=768 on the streamed branch against the JAX
    package's Pallas kernel in interpret mode."""
    hsz = 768
    gx, whh = _rand((3, 5, 3 * hsz), 13), _rand((hsz, 3 * hsz), 14, 0.05)
    bhh = _rand((3 * hsz,), 15, 0.1)
    want = np.asarray(jl.gru_scan_tm(gx, whh, bhh, True, 256, True,
                                     jnp.float32))
    with torch.no_grad():
        got = tg.gru_scan_tm(*map(torch.from_numpy, (gx, whh, bhh)), True,
                             out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL)
    assert _only(launches, gru_scan_fwd_stream=1)


SB640 = dict(num_freqs=17, sb_num_neighbors=2, fb_model_hidden_size=32,
             sb_model_hidden_size=640, num_groups_in_drop_band=1)


def _sb640_inputs(batch=2, frames=9):
    return tuple(np.abs(_rand((batch, 1, 17, frames), 20)) if i == 0
                 else _rand((batch, 1, 17, frames), 20 + i) for i in range(3))


def _sb640_port(params):
    port = FullSubNetPlus(FullSubNetPlusConfig(**SB640),
                          compute_dtype=torch.float32, device="cpu")
    port.load_state_dict(convert.convert_fullsubnet_plus(params))
    return port.eval()


def test_fullsubnet_plus_sb640_matches_jax():
    """A small FullSubNet+ whose sub-band LSTM has 640 units (the width no
    resident cluster holds), float32 on the CPU on both sides, numpy-made
    weights in the JAX layout: within 1e-4 of the output's peak."""
    jcfg = JaxFullSubNetPlusConfig(**SB640)
    params = convert.random_fullsubnet_plus_params(jcfg, seed=5)
    inputs = _sb640_inputs()
    want = np.asarray(jax.jit(JaxFullSubNetPlus(jcfg).apply)(
        {"params": params}, *inputs))
    with torch.no_grad():
        got = _sb640_port(params)(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fullsubnet_plus_sb640_takes_the_streamed_scans(launches,
                                                        monkeypatch):
    """The same model on the kernels' route (float32 layers take the mixed
    route, as on the card): its two sub-band LSTM layers launch
    lstm_scan_fwd_stream once each, and the output equals the CPU branch's
    on the same route."""
    monkeypatch.setattr(R._RecurrentLayer, "route",
                        lambda self, device: "mixed")
    params = convert.random_fullsubnet_plus_params(
        JaxFullSubNetPlusConfig(**SB640), seed=5)
    port = _sb640_port(params)
    inputs = tuple(map(torch.from_numpy, _sb640_inputs()))
    with torch.no_grad():
        got = port(*inputs)
        assert _only(launches, lstm_scan_fwd_stream=2), launches
        want = _cpu(lambda: port(*inputs))
    assert torch.equal(got, want)
