"""The streamed cluster backwards of kernel D and of the GRU backward scan
(csrc/scan_bwd_stream.cu, entries `lstm_scan_bwd_stream` and
`gru_scan_bwd_stream`) on the CPU: their layouts against the source, the
planner (ops/lstm.py plan_bwd, plan_bwd_stream) and the route it takes
among the single block, the resident clusters and the streamed cluster,
the two packed W_hh operands, the planned wrappers handing a streamed plan
to the entry, the wrappers' kernel branch (launches faked by
tests/test_torch_lstm_backward.py and tests/test_torch_gru.py, which unpack
both operands and run the plain versions) against their CPU branch and,
through LSTMScan and GRUScan, against the JAX package's Pallas kernels in
interpret mode, and a FullSubNet+ training step whose sub-band LSTM no
single block holds (sb_model_hidden_size=1040) against the JAX model.

The tolerances: the kernel branch equals the CPU branch bit for bit (the
fakes compute the plain versions on the real units); against Pallas the
bf16 ones of tests/test_torch_lstm_backward.py (a float32 difference that
crosses a bf16 rounding boundary moves a value by one bf16 step); the
model in float32 on both sides at 1e-4 of the gradients' peak (float32
sums in another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu import train as JT
from generative_audio_tpu.models import FullSubNetPlusConfig as JaxConfig
from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch import train as TT
from generative_audio_torch.models import FullSubNetPlusConfig
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from generative_audio_torch.utils import convert
from test_torch_bwd_plan import _c_function
from test_torch_gru import fake_launch as gru_fake_launch
from test_torch_lstm_backward import fake_launch as lstm_fake_launch
from torch_stream_stubs import (stream_dh_weight_rows, stream_weight_rows,
                                stub_bwd_plans, stub_stream_bwd_occupancy,
                                stub_stream_plans)

torch.set_num_threads(2)
KINDS = {"lstm": (tl, 4), "gru": (tg, 3)}
SOURCE = "scan_bwd_stream.cu"
LAYOUT_HIDDEN = [("lstm", h) for h in (528, 640, 768, 1024, 1040, 1536,
                                       2304)] + [
    ("gru", h) for h in (528, 640, 1024, 1088, 1536, 2304)]
ROWS = (1, 18, 2304)
BF16 = dict(atol=1e-2, rtol=1e-2)
# the largest H the single blocks hold: kernel D's dc in registers, the
# GRU's shared memory
BLOCK_MAX = {"lstm": 1024, "gru": 1072}


def resident_clusters(cluster, rows, resident=False):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM, as
    tests/test_torch_bwd_plan.py fakes it."""
    return 15 if cluster == 8 else 7


def stream_clusters(hsz, cluster, rows, resident, stages, tile):
    return resident_clusters(cluster, rows)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


def _source_smem(kind, hsz, cluster, rows, resident, stages, tile):
    """stream_bwd_smem of the source, evaluated (slot_bytes and
    slice_stride from the same source)."""
    n = KINDS[kind][1]
    slot = _c_function(SOURCE, "__host__ __device__ inline int slot_bytes("
                               "int U, int n)")
    stride = _c_function(SOURCE, "__host__ __device__ inline int "
                                 "slice_stride(int U, int n)")
    smem = _c_function(SOURCE, "size_t stream_bwd_smem(int H, int C, int R, "
                               "int n, int resident, int stages,\n"
                               "                       int tile)")
    env = dict(U=hsz // cluster, r=rows, R=rows, C=cluster, H=hsz, n=n,
               resident=resident, stages=stages, tile=tile, PAD=8)
    env["slot_bytes"] = lambda u, k: eval(slot, {}, dict(U=u, n=k))
    env["slice_stride"] = lambda u, k: eval(stride, {}, dict(U=u, n=k))
    return eval(smem, {}, env)


def test_source_constants_are_the_planner_s():
    """The warps and items a CTA of the source takes are the planner's."""
    text = (_cuda.CSRC / SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("ITEMS_PER_WARP") == tl._BWD_ITEMS_PER_WARP
    assert const("ROLE_WARPS") == tl._BWD_ROLE_WARPS
    assert const("MAX_ITEMS") == tl._BWD_STREAM_MAX_ITEMS
    # 18 items of one row tile in 6 warps of 3; 16 items of two tiles in 6
    # of 3; 12 items of three tiles in 6 of 2; eight tiles of one group, or
    # four tiles of four, take more than 7 warps
    assert tl.bwd_warp_items(1, 18) == 3 and tl.bwd_warp_items(2, 8) == 3
    assert tl.bwd_warp_items(3, 4) == 2 and tl.bwd_warp_items(7, 1) == 1
    assert tl.bwd_warp_items(1, 19) == 0 and tl.bwd_warp_items(8, 1) == 0
    assert tl.bwd_warp_items(4, 4) == 0


@pytest.mark.parametrize("kind,hsz", LAYOUT_HIDDEN)
def test_stream_layout_is_the_source_and_fits(kind, hsz):
    """The streamed planner's plans at 1, 18 and 2304 rows: the shared bytes
    are the source's layout, within SMEM_LIMIT, at H padded to whole 8-unit
    groups of each CTA and whole k-pairs, with at least one slot streamed
    and no deeper ring than the streamed slots; every resident count of the
    plan's shape and the other way of holding the tile give the source's
    bytes too."""
    module, n = KINDS[kind]
    for rows in ROWS:
        plan = module.plan_bwd_stream_scan(hsz, rows, stream_clusters)
        hp, c, r = plan.hidden, plan.cluster, plan.rows
        assert plan.design == "stream"
        assert hp == tl.stream_hidden(hsz, c) >= hsz
        assert hp % (8 * c) == 0 and hp % 32 == 0
        assert tl.bwd_warp_items(r // 16, hp // c // 8) > 0
        assert 0 <= plan.resident < hp // 32
        assert 1 <= plan.stages <= hp // 32 - plan.resident
        assert plan.smem_bytes <= tl.SMEM_LIMIT and plan.smem_bytes % 16 == 0
        assert plan.smem_bytes == module.bwd_stream_smem_bytes(
            hp, c, r, plan.resident, plan.stages, plan.tile) == _source_smem(
            kind, hp, c, r, plan.resident, plan.stages, plan.tile)
        assert plan.clusters == -(-rows // r)
        assert plan.waves == -(-plan.clusters // plan.active)
        assert plan.launch_args == (c, r, plan.resident, plan.stages,
                                    int(plan.tile), plan.smem_bytes)
        for resident in range(plan.resident + 1):
            for tile in (True, False):
                assert module.bwd_stream_smem_bytes(
                    hp, c, r, resident, plan.stages, tile) == _source_smem(
                    kind, hp, c, r, resident, plan.stages, tile)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_plan_for_every_hidden_up_to_2304(kind):
    """Both planners return a plan for every multiple of 16 up to 2304 (the
    forwards' limit) and raise above it: the streamed cluster wherever the
    single block no longer holds H."""
    module = KINDS[kind][0]
    for hsz in range(16, 2305, 16):
        plan = module.plan_bwd_scan(hsz, 18, resident_clusters)
        if hsz > BLOCK_MAX[kind]:
            assert plan.design == "stream" and plan.hidden >= hsz
        if hsz <= 512:
            assert plan.design != "stream"
    for hsz in (1040, 2304):
        assert module.plan_bwd_scan(hsz, 2304, resident_clusters).design == \
            "stream"
    for hsz in (2320, 2400, 3072):
        with pytest.raises(ValueError, match=f"no plan for the {kind.upper()} "
                                             f"backward scan at H={hsz}"):
            module.plan_bwd_scan(hsz, 18, resident_clusters)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_route_weighs_the_three_designs(kind, monkeypatch):
    """The least waves x modelled step: the resident cluster at the
    sub-band shape (no streamed plan weighed up to H=512; within
    resident_backwards(), outside it the wide cluster of both kernels); the
    streamed
    cluster at H=768 and 18 rows, whose model beats the single block's;
    the single block where no streamed cluster runs on the card or its
    model wins (a stand-in step); above the single block's H only the
    streamed cluster, and nothing where the card runs none."""
    module = KINDS[kind][0]
    with tl.resident_backwards():
        assert module.plan_bwd_scan(384, 2304, resident_clusters).design == \
            "cluster"
    assert module.plan_bwd_scan(384, 2304, resident_clusters).design == \
        "wide"
    stream = module.plan_bwd_scan(768, 18, resident_clusters)
    block = module.plan_bwd_scan(768, 18, resident_clusters,
                                 stream_clusters=lambda *a: 0)
    assert stream.design == "stream" and block.design == "block"
    assert stream.waves * stream.step_us < block.waves * block.step_us
    assert stream == module.plan_bwd_stream_scan(768, 18, stream_clusters)
    monkeypatch.setattr(module, "_BWD_BLOCK_US", 1.0)
    assert module.plan_bwd_scan(768, 18, resident_clusters).design == "block"
    big = BLOCK_MAX[kind] + 16
    assert module.plan_bwd_scan(big, 18, resident_clusters).design == "stream"
    with pytest.raises(ValueError, match="the card runs no such cluster"):
        module.plan_bwd_scan(big, 18, resident_clusters,
                             stream_clusters=lambda *a: 0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stream_step_model(kind):
    """The modelled step grows with the streamed slots and the rows, a ring
    of one stage waits a copy's latency for each slot, and reading the
    peers' slices in place costs what the whole tile's exchange does not."""
    module = KINDS[kind][0]
    base = module.bwd_stream_step_us(1024, 16, 16, 4, 2, True)
    assert module.bwd_stream_step_us(1024, 16, 16, 2, 2, True) > base
    assert module.bwd_stream_step_us(1024, 16, 32, 4, 2, True) > base
    assert module.bwd_stream_step_us(1024, 16, 16, 4, 1, True) >= base
    assert module.bwd_stream_step_us(384, 16, 16, 0, 2, True) > \
        module.bwd_step_us(384, 16, 16, True)


@pytest.mark.parametrize("kind,cluster,hp", [("lstm", 16, 256),
                                             ("lstm", 8, 384),
                                             ("gru", 16, 384)])
def test_dh_weight_is_fragment_ordered(kind, cluster, hp):
    """The second product's packed operand: for CTA rank k, k-pair p, unit
    group g and lane (grp, tq), the 8 bf16 of (kk, half, e) are
    W_hh[k U + 8g + grp, 32p + 16kk + 8half + 2tq + e]; n consecutive
    k-pairs are one slot of n U 64 bytes, as one k-pair of the recompute's
    operand; unpacking gives the padded W_hh back."""
    n = KINDS[kind][1]
    hsz = hp - 8
    w_hh = torch.from_numpy(_rand((hsz, n * hsz), 5))
    wdh = tl._stream_dh_weight(w_hh, hp, cluster)
    w = tl._padded_weight(w_hh, hp)
    units = hp // cluster
    groups = units // 8
    assert wdh.is_contiguous() and wdh.dtype == torch.bfloat16
    assert tuple(wdh.shape) == (cluster, n * hp // 32, groups, 8, 4, 2, 2, 2)
    assert wdh[0, :n].numel() * 2 == n * units * 64
    assert tl._stream_weight(w_hh, hp, cluster)[0, 0].numel() * 2 == \
        n * units * 64
    rng = np.random.default_rng(6)
    for _ in range(200):
        k, p, g = (int(rng.integers(cluster)), int(rng.integers(n * hp // 32)),
                   int(rng.integers(groups)))
        grp, tq, kk, half, e = (int(rng.integers(m)) for m in (8, 4, 2, 2, 2))
        assert wdh[k, p, g, grp, tq, kk, half, e] == w[
            k * units + 8 * g + grp, 32 * p + 16 * kk + 8 * half + 2 * tq + e]
    plan = tl.BwdStreamPlan(hp, cluster, 16, 0, 1, True, 1, 1, 1, 0, 0.0)
    assert torch.equal(stream_dh_weight_rows(wdh, plan, n), w)
    assert torch.equal(stream_weight_rows(tl._stream_weight(w_hh, hp, cluster),
                                          plan, n), tl._kernel_weight(w_hh, hp))


def _lstm_operands(t, b, h, seed):
    return (_bf16(_rand((t, b, 4 * h), seed, 1.0)),
            _bf16(_rand((t, b, h), seed + 1)), _bf16(_rand((t, b, h), seed + 2)),
            _bf16(_rand((t, b, h), seed + 3, 1.0)),
            torch.from_numpy(_rand((h, 4 * h), seed + 4, 0.05)))


def _gru_operands(t, b, h, seed):
    return (_bf16(_rand((t, b, 3 * h), seed, 1.0)),
            _bf16(_rand((t, b, h), seed + 1)),
            _bf16(_rand((t, b, h), seed + 2, 1.0)),
            torch.from_numpy(_rand((h, 3 * h), seed + 3, 0.05)),
            torch.from_numpy(_rand((3 * h,), seed + 4, 0.1)))


@pytest.fixture
def entries(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch faked
    (both modules' launch helpers run): records (entry, arguments) and
    launches nothing."""
    calls = []
    for module in (tl, tg):
        monkeypatch.setattr(module, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("hsz", [384, 600])
def test_planned_wrappers_hand_the_streamed_plan(kind, hsz, entries):
    """A streamed plan given to the planned wrapper (at H=384, where the
    resident cluster holds H too, and H=600, padded to the plan's units)
    reaches its `_stream` entry: the operands at the plan's H, both W_hh
    operands packed for its cluster, the plan's launch arguments last. A
    plan of another layer is refused before anything launches."""
    module, n = KINDS[kind]
    plan = module.plan_bwd_stream_scan(-(-hsz // 16) * 16, 40,
                                       stream_clusters)
    hp = plan.hidden
    if kind == "lstm":
        ops = _lstm_operands(3, 40, hsz, seed=1)
        out = tl.lstm_scan_bwd_planned_tm(*ops, plan, reverse=True)
        assert out.shape == (3, 40, 4 * hsz)
        k = 4
    else:
        ops = _gru_operands(3, 40, hsz, seed=2)
        dgx, dhn, db = tg.gru_scan_bwd_streams_planned_tm(*ops, plan,
                                                          reverse=True)
        assert dgx.shape == (3, 40, 3 * hsz) and dhn.shape == (3, 40, hsz)
        assert db.shape == (3, 3 * hsz)          # one row a 16-row tile
        k = 3
    (name, args), = entries
    assert name == f"{kind}_scan_bwd_stream"
    assert args[-10:] == (3, 40, hp, 1, *plan.launch_args)
    assert args[0].shape == (3, 40, n * hp)
    assert args[k].shape == (plan.cluster, hp // 32, n * hp // plan.cluster
                             // 8, 8, 4, 2, 2, 2)
    assert args[k + 1].shape == (plan.cluster, n * hp // 32,
                                 hp // plan.cluster // 8, 8, 4, 2, 2, 2)
    other = module.plan_bwd_stream_scan(hp + 256, 40, stream_clusters)
    with pytest.raises(ValueError, match="is for no layer"):
        if kind == "lstm":
            tl.lstm_scan_bwd_planned_tm(*ops, other)
        else:
            tg.gru_scan_bwd_streams_planned_tm(*ops, other)
    assert len(entries) == 1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wrappers_ask_the_card_above_512(kind, entries, monkeypatch):
    """The unplanned wrapper asks card_bwd_scan_plan for H above 512 itself
    (a streamed plan sets the H it runs at) and hands the plan to the
    entry; up to H=512 the launch helper asks for it, as before."""
    module = KINDS[kind][0]
    asked = []

    def card_plan(device, hsz, batch):
        asked.append((hsz, batch))
        return module.plan_bwd_scan(hsz, batch, resident_clusters)

    monkeypatch.setattr(module, "card_bwd_scan_plan", card_plan)
    for hsz, entry in ((1000, f"{kind}_scan_bwd_stream"),
                       (512, f"{kind}_scan_bwd")):
        if kind == "lstm":
            tl.lstm_scan_bwd_tm(*_lstm_operands(2, 18, hsz, seed=3))
        else:
            tg.gru_scan_bwd_streams_tm(*_gru_operands(2, 18, hsz, seed=4))
        name, args = entries[-1]
        assert name == entry and asked[-1] == (-(-hsz // 16) * 16, 18)
        plan = card_plan(None, -(-hsz // 16) * 16, 18)
        assert args[-len(plan.launch_args):] == plan.launch_args
    assert len(asked) == 4


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of both modules' wrappers on CPU tensors, with the
    fakes of the two test files and the plans of a stub occupancy."""
    for mod, fake in ((tl, lstm_fake_launch), (tg, gru_fake_launch)):
        monkeypatch.setattr(mod, "_is_cuda", lambda *tensors: True)
        monkeypatch.setattr(mod, "_launch", fake)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    stub_bwd_plans(monkeypatch)
    return tl.launch_counts


def _cpu(fn):
    """fn() on the CPU branch of both modules' wrappers."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tl, tg):
            mp.setattr(mod, "_is_cuda", lambda *tensors: False)
        return fn()


def _only(launches, **expect):
    return launches == {**dict.fromkeys(launches, 0), **expect}


def _reset(launches):
    for name in launches:
        launches[name] = 0


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_stream_branch_equals_cpu_branch(launches, reverse):
    """Kernel D at H=640 (the streamed route) and H=600 (padded to the
    plan's units), 21 rows, and under a forced streamed plan at H=384: one
    launch of lstm_scan_bwd_stream each, dgates == the CPU branch's."""
    for hsz in (640, 600, 384):
        ops = _lstm_operands(4, 21, hsz, seed=hsz)
        _reset(launches)
        if hsz == 384:
            plan = tl.plan_bwd_stream_scan(384, 21, stub_stream_bwd_occupancy)
            got = tl.lstm_scan_bwd_planned_tm(*ops, plan, reverse)
        else:
            got = tl.lstm_scan_bwd_tm(*ops, reverse)
        assert _only(launches, lstm_scan_bwd_stream=1), launches
        want = _cpu(lambda: tl.lstm_scan_bwd_tm(*ops, reverse))
        assert got.dtype == want.dtype and torch.equal(got, want), hsz


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_stream_branch_equals_cpu_branch(launches, reverse):
    """The GRU backward scan at H=640 (the streamed route) and H=600
    (padded to the plan's units), and under a forced streamed plan at
    H=384, over rows that one 16-row block holds (the fake computes a block
    at a time, and the CPU's products over more rows may sum in another
    order): one launch of gru_scan_bwd_stream each; dgx, dhn and db_hh ==
    the CPU branch's."""
    for hsz, rows in ((640, 13), (600, 11), (384, 13)):
        ops = _gru_operands(4, rows, hsz, seed=hsz + rows)
        _reset(launches)
        if hsz == 384:
            plan = tg.plan_bwd_stream_scan(384, rows, stub_stream_bwd_occupancy)
            dgx, dhn, db = tg.gru_scan_bwd_streams_planned_tm(*ops, plan,
                                                              reverse)
            db = db.sum(dim=0)
        else:
            dgx, dhn, db = tg.gru_scan_bwd_streams_tm(*ops, reverse)
        assert _only(launches, gru_scan_bwd_stream=1), launches
        want = _cpu(lambda: tg.gru_scan_bwd_streams_tm(*ops, reverse))
        for got, exp in zip((dgx, dhn, db), want):
            assert got.dtype == exp.dtype and torch.equal(got, exp), hsz


def _grads(fn, arrays, ct):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*ts) * torch.from_numpy(ct)).sum().backward()
    return [t.grad.numpy() for t in ts]


def test_lstm_scan_gradients_through_the_stream_match_jax(launches):
    """LSTMScan at H=640 on the kernels' branch (the streamed training
    forward and lstm_scan_bwd_stream, faked) against jax.grad through the
    Pallas training and backward kernels in interpret mode."""
    t, b, h = 5, 3, 640
    gx, whh = _rand((t, b, 4 * h), 30), _rand((h, 4 * h), 31, 0.05)
    ct = _rand((t, b, h), 32)

    def jax_loss(g_, w_):
        return jnp.sum(jl.lstm_scan_tm(g_, w_, False, 16, True, jnp.float32)
                       * ct)

    want = jax.grad(jax_loss, argnums=(0, 1))(gx, whh)
    got = _grads(lambda g, w: tl.lstm_scan_tm(g, w, False, torch.float32),
                 (gx, whh), ct)
    assert _only(launches, lstm_scan_fwd_train_stream=1,
                 lstm_scan_bwd_stream=1), launches
    for a, w_ in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w_), **BF16)


def test_gru_scan_gradients_through_the_stream_match_jax(launches):
    """GRUScan at H=640 on the kernels' branch (the resident cluster
    forward, gru_scan_bwd_stream and the dW_hh contraction, faked) against
    jax.grad through the Pallas kernels in interpret mode."""
    t, b, h = 5, 3, 640
    gx, whh = _rand((t, b, 3 * h), 33), _rand((h, 3 * h), 34, 0.05)
    bhh, ct = _rand((3 * h,), 35, 0.1), _rand((t, b, h), 36)

    def jax_loss(g_, w_, b_):
        return jnp.sum(jl.gru_scan_tm(g_, w_, b_, True, 8, True, jnp.float32)
                       * ct)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(gx, whh, bhh)
    got = _grads(lambda g, w, b_: tg.gru_scan_tm(g, w, b_, True,
                                                 torch.float32),
                 (gx, whh, bhh), ct)
    assert _only(launches, gru_scan_fwd=1, gru_scan_bwd_stream=1,
                 gru_scan_bwd_dwhh=1), launches
    for a, w_ in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(w_), **BF16)


SB1040 = dict(num_freqs=8, sb_num_neighbors=2, fb_model_hidden_size=16,
              sb_model_hidden_size=1040, num_groups_in_drop_band=1)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_fullsubnet_plus_sb1040_step_matches_jax():
    """A float32 training step's loss and gradients of a small FullSubNet+
    whose sub-band LSTM has 1040 units (no single block of kernel D holds
    it; on the card the streamed backward trains it), on the CPU against
    the JAX model: within 1e-4 of the gradients' peak."""
    kw = dict(n_fft=14, hop_length=8, win_length=14, compute_dtype="float32")
    jcfg = JT.EnhanceTrainConfig(model=JaxConfig(**SB1040), **kw)
    tcfg = TT.EnhanceTrainConfig(model=FullSubNetPlusConfig(**SB1040), **kw)
    rng = np.random.default_rng(40)
    clean = rng.standard_normal((2, 96)).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal((2, 96)).astype(np.float32)
    params = convert.random_fullsubnet_plus_params(jcfg.model, seed=5)
    want, want_grads = jax.jit(jax.value_and_grad(JT.enhance_loss_fn),
                               static_argnums=3)(params, noisy, clean, jcfg)
    state = TT.init_enhance_state(tcfg, seed=0, device="cpu")
    state.model.load_state_dict(convert.convert_fullsubnet_plus(
        jax.tree_util.tree_map(np.asarray, params)))
    got = TT.enhance_loss_fn(state.model, torch.from_numpy(noisy),
                             torch.from_numpy(clean), tcfg)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    got_grads = _leaves(convert.to_jax_fullsubnet_plus(grads))
    want_grads = _leaves(want_grads)
    assert set(got_grads) == set(want_grads)
    peak = max(np.abs(w).max() for w in want_grads.values())
    assert peak > 0
    for key, w in want_grads.items():
        assert np.abs(got_grads[key] - w).max() <= 1e-4 * peak, key
