"""Kernels E and F as streamed clusters (csrc/lstm_staged_stream.cu:
`lstm_scan_fwd_unrolled_stream` and `lstm_layer_fwd_stream`, the route of
`lstm_scan_tm(..., block_t=K)` / `lstm_unrolled` and of `lstm_layer_tm`
above H = 512) on the CPU: their layouts against the source, the planners
and the routes (ops/lstm.py plan_unrolled_stream, plan_layer_stream,
unrolled_route, layer_route) with the stub H100 occupancy of
tests/torch_stream_stubs.py, the refusals above the largest H, the
wrappers' kernel branch (launches faked by tests/test_torch_lstm_layer.py
and tests/test_torch_lstm_variants.py, which unpack the packed operands and
run the plain versions) against their CPU branch, and against the JAX
package's Pallas kernels in interpret mode: the layer (`lstm_layer_tm`),
also over a two-layer stack whose JAX-layout weights utils/convert.py
carries across, and the script's unrolled forward (scripts/perf_lstm_unroll.py,
loaded by file path as tests/test_torch_lstm_variants.py loads it).

The tolerances: the kernel branch equals the CPU branch bit for bit (the
fakes compute the plain versions on the real units, which the padded units
leave unchanged); against Pallas the bf16 ones, 1e-2 absolute and relative:
both sides compute the same bf16 algorithm and differ in the order of the
sums and in the transcendental functions, and a float32 difference that
crosses a bf16 rounding boundary moves h by one bf16 step (2^-8 relative)
for the next product.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import lstm as tl
from generative_audio_torch.scripts import perf_lstm_unroll as tu
from generative_audio_torch.utils import convert
from test_torch_lstm_layer import fake_launch as layer_fake_launch
from test_torch_lstm_variants import _load_script, _unrolled_interpret
from test_torch_lstm_variants import fake_launch as variants_fake_launch
from torch_stream_stubs import stream_weight_rows, stub_occupancy
from torch_stream_stubs import stub_stream_plans

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
CPU = torch.device("cpu")
SOURCE = "lstm_staged_stream.cu"
ROWS = (1, 18, 2056)
LARGEST_E = {2: 2304, 4: 2048}      # kernel E's largest H by K
LARGEST_F = 2304


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _source_smem(name, **env):
    """The shared bytes of the source's function `name`, evaluated: its
    return expression with the casts dropped, integer division, and
    pair_bytes from the same source."""
    text = (_cuda.CSRC / SOURCE).read_text()

    def body(fn):
        b = re.search(rf"\b{fn}\([^)]*\) \{{(.*?)\n\}}", text, re.S).group(1)
        expr = " ".join(b[b.rindex("return") + 6:].split()).rstrip(";")
        return expr.replace("(size_t)", "").replace("/", "//")

    pair = body("pair_bytes")
    env["pair_bytes"] = lambda u: eval(pair, {}, dict(U=u))
    env.update(U=env["H"] // env["C"], hs=env["H"] + 8, r=env["R"])
    return eval(body(name), {}, env)


def _unrolled_occupancy(h, c, r, res, stages, groups):
    return stub_occupancy(h, c, r, res, stages)


def _check_plan(plan, hsz, batch):
    hp = plan.hidden
    assert hp == tl.stream_hidden(hsz, plan.cluster) >= hsz
    assert hp % (8 * plan.cluster) == 0 and hp % 32 == 0
    assert plan.resident % 2 == 0 and plan.resident < hp // 16
    assert 1 <= plan.stages <= hp // 32 - plan.resident // 2
    assert plan.rows // 16 * (hp // plan.cluster // 8) <= 18
    assert plan.clusters == -(-batch // plan.rows)
    assert plan.waves == -(-plan.clusters // plan.active)
    assert plan.smem_bytes <= tl.SMEM_LIMIT and plan.smem_bytes % 8 == 0


@pytest.mark.parametrize("hsz", [640, 768, 1024, 1536, 2048, 2304])
@pytest.mark.parametrize("k", [2, 4])
def test_unrolled_stream_layout_is_the_source(hsz, k):
    """Kernel E's streamed plans at 1, 18 and 2056 rows (stub occupancy):
    the shared bytes are the source's layout (the gates ring of the plan's
    groups, the W_hh^T ring and resident k-pairs, the h buffers, the
    mbarriers and the TMA ring's alignment slack), within SMEM_LIMIT, for
    the plan and for every resident count it could have; above K=4's
    largest H not even one group fits."""
    if hsz > LARGEST_E[k]:
        with pytest.raises(ValueError, match="no streamed plan"):
            tl.plan_unrolled_stream(hsz, 18, k, _unrolled_occupancy)
        return
    for rows in ROWS:
        plan = tl.plan_unrolled_stream(hsz, rows, k, _unrolled_occupancy)
        _check_plan(plan, hsz, rows)
        assert plan.groups in tl.UNROLL_STREAM_GROUPS
        assert plan.launch_args == (plan.cluster, plan.rows, plan.resident,
                                    plan.stages, plan.groups, plan.smem_bytes)
        for resident in range(0, plan.resident + 1, 2):
            assert tl.unrolled_stream_smem_bytes(
                plan.hidden, plan.cluster, plan.rows, k, resident,
                plan.stages, plan.groups) == _source_smem(
                "unrolled_stream_smem", H=plan.hidden, C=plan.cluster,
                R=plan.rows, K=k, resident=resident, stages=plan.stages,
                groups=plan.groups)
        assert plan.smem_bytes == tl.unrolled_stream_smem_bytes(
            plan.hidden, plan.cluster, plan.rows, k, plan.resident,
            plan.stages, plan.groups)


@pytest.mark.parametrize("hsz", [640, 1024, 1536, 2304])
@pytest.mark.parametrize("f", [34, None])
def test_layer_stream_layout_is_the_source(hsz, f):
    """Kernel F's streamed plans at F=34 and F=H: its layout has no gates
    and no c (registers), so whatever F it is the W_hh^T ring, the resident
    k-pairs, the h buffers and the mbarriers, the source's bytes."""
    f = f or hsz
    for rows in ROWS:
        plan = tl.plan_layer_stream(hsz, rows, f, stub_occupancy)
        _check_plan(plan, hsz, rows)
        assert type(plan) is tl.StreamPlan
        for resident in range(0, plan.resident + 1, 2):
            assert tl.layer_stream_smem_bytes(
                plan.hidden, plan.cluster, plan.rows, resident,
                plan.stages) == _source_smem(
                "layer_stream_smem", H=plan.hidden, C=plan.cluster,
                R=plan.rows, resident=resident, stages=plan.stages)


def test_sources_declare_their_entries():
    """Without a compiler: the two entries take the arguments ops/_cuda.py
    declares, ending in their plan and the stream, and the occupancy query
    its instance flags; the launch counts know both entries."""
    text = (_cuda.CSRC / SOURCE).read_text()
    tails = {"lstm_scan_fwd_unrolled_stream": [
                 "k", "cluster", "rows", "resident", "stages", "groups",
                 "smem_bytes", "stream"],
             "lstm_layer_fwd_stream": [
                 "reverse", "cluster", "rows", "resident", "stages",
                 "smem_bytes", "stream"]}
    assert set(_cuda._SIGNATURES["lstm_staged_stream"]) == set(tails)
    for name, argtypes in _cuda._SIGNATURES["lstm_staged_stream"].items():
        params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert len(names) == len(argtypes)
        assert names[-len(tails[name]):] == tails[name]
        assert tl._SOURCE_OF[name] == "lstm_staged_stream"
        assert name in tl.launch_counts
    query = re.search(r"\bint lstm_staged_stream_max_clusters\(([^)]*)\)",
                      text)
    assert " ".join(query.group(1).split()) == (
        "int k, int out_f32, int resident, int stages, int groups, int H, "
        "int cluster, int rows, int* n")
    assert len(_cuda._QUERIES["lstm_staged_stream"][
        "lstm_staged_stream_max_clusters"]) == 9


@pytest.mark.parametrize("hsz", [640, 768, 1024, 1536])
def test_routes_by_modelled_time(hsz, monkeypatch):
    """Above H=512 the route of both kernels is plan_forward's: the
    streamed cluster, whose modelled waves x step beat the single block's
    at every H either holds, at 18 and 2056 rows; single_block_forwards()
    forces the single block where it fits; the layouts alone (no device)
    take the streamed cluster too."""
    stub_stream_plans(monkeypatch)
    for rows in (18, 2056):
        for k in tl.UNROLL_STEPS:
            hp, suffix, plan = tl.unrolled_route(hsz, k, rows, CPU)
            assert suffix == "_stream" and hp == plan.hidden
            assert isinstance(plan, tl.UnrolledStreamPlan)
            assert plan == tl.plan_unrolled_stream(hsz, rows, k,
                                                   _unrolled_occupancy)
        for f in (34, hsz):
            hp, suffix, plan = tl.layer_route(hsz, f, rows, CPU)
            assert suffix == "_stream" and hp == plan.hidden
            assert plan == tl.plan_layer_stream(hsz, rows, f, stub_occupancy)
            assert tl.layer_route(hsz, f)[1] == "_stream"
    with tl.single_block_forwards():
        for k in tl.UNROLL_STEPS:
            if tl.unrolled_block_smem_bytes(
                    -(-hsz // 16) * 16, 4, k) <= tl.SMEM_LIMIT:
                assert tl.unrolled_route(hsz, k, 18, CPU) == (
                    -(-hsz // 16) * 16, "_block", None)
        assert tl.layer_route(hsz, 34, 18, CPU) == (hsz, "_block", None)


@pytest.mark.parametrize("hsz", [384, 512])
def test_streamed_forwards_force_the_stream_where_a_cluster_holds(
        hsz, monkeypatch):
    """At H=384 and 512 the resident clusters are the route; within
    streamed_forwards() both kernels take their streamed clusters, with the
    planner's resident k-steps or the given ones."""
    stub_stream_plans(monkeypatch)
    assert tl.unrolled_route(hsz, 2, 40, CPU) == (hsz, "", None)
    assert tl.layer_route(hsz, 34, 40, CPU) == (hsz, "", None)
    with tl.streamed_forwards():
        for k in tl.UNROLL_STEPS:
            hp, suffix, plan = tl.unrolled_route(hsz, k, 40, CPU)
            assert (hp, suffix) == (hsz, "_stream") and plan.resident > 0
        assert tl.layer_route(hsz, 34, 40, CPU)[1] == "_stream"
    with tl.streamed_forwards(resident_ksteps=2):
        assert tl.unrolled_route(hsz, 4, 40, CPU)[2].resident == 2
        assert tl.layer_route(hsz, hsz, 40, CPU)[2].resident == 2


def test_refusals_above_the_largest_h(monkeypatch):
    """Kernel E takes H up to 2304 at K=2 and 2048 at K=4 (one group of K
    steps of gates beside the h buffers; its single block stops at 1600
    and 1104); kernel F up to 2304 at any F (its single block stops at 1776
    for F=34 and near 1200 for F=H). Above, both raise on either device,
    naming the bytes (kernel F on the kernel branch; its CPU branch is the
    plain version)."""
    for k, largest in LARGEST_E.items():
        assert tl.unrolled_hidden(largest, k) == largest
        with pytest.raises(ValueError, match=r"needs \d+ B"):
            tl.unrolled_hidden(largest + 16, k)
    with pytest.raises(ValueError, match="244376 B at 16 rows"):
        tl.unrolled_hidden(2064, 4)
    for f in (34, 384, None):
        assert tl.layer_route(LARGEST_F, f or LARGEST_F)[:2] == (
            LARGEST_F, "_stream")
        with pytest.raises(ValueError, match=r"19 items at 16 rows.*single "
                                             r"block needs \d+ B"):
            tl.layer_route(LARGEST_F + 16, f or LARGEST_F + 16)
    # the single block's own limits, which the streamed route lifts
    assert tl.layer_block_smem_bytes(1776, 34) <= tl.SMEM_LIMIT
    assert tl.layer_block_smem_bytes(1792, 34) == 233472 > tl.SMEM_LIMIT
    assert tl.layer_block_smem_bytes(1616, 384) <= tl.SMEM_LIMIT
    assert tl.layer_block_smem_bytes(1632, 384) > tl.SMEM_LIMIT
    assert tl.layer_block_smem_bytes(1536, 1536) == 295936 > tl.SMEM_LIMIT
    gates = torch.zeros(4, 2, 4 * 2064, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="244376 B"):
        tl.lstm_scan_tm(gates, torch.zeros(2064, 4 * 2064), block_t=4)
    stub_stream_plans(monkeypatch)
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", None)            # nothing launches
    h = LARGEST_F + 16
    with pytest.raises(ValueError, match="no forward for the LSTM layer"):
        with torch.no_grad():
            tl.lstm_layer_tm(torch.zeros(2, 3, 6), torch.zeros(6, 4 * h),
                             torch.zeros(h, 4 * h), torch.zeros(4 * h))


def test_step_models():
    """Kernel E's step with one gate group waits the group's copy over its
    K steps; kernel F's grows with the x product's k-steps and items; both
    grow with the streamed k-pairs."""
    one = tl.unrolled_stream_step_us(768, 16, 16, 8, 2, 2, 1)
    two = tl.unrolled_stream_step_us(768, 16, 16, 8, 2, 2, 2)
    assert one > two and tl.unrolled_stream_step_us(
        768, 16, 16, 8, 2, 4, 1) < one
    assert tl.unrolled_stream_step_us(768, 16, 16, 4, 2, 2, 2) > two
    assert tl.layer_stream_step_us(768, 16, 16, 8, 2, 768) > \
        tl.layer_stream_step_us(768, 16, 16, 8, 2, 34)
    assert tl.layer_stream_step_us(768, 16, 32, 8, 2, 34) > \
        tl.layer_stream_step_us(768, 16, 16, 8, 2, 34)


def test_card_plans_ask_for_the_instance(monkeypatch):
    """card_unrolled_stream_plan asks lstm_staged_stream_max_clusters with
    (k, 0, resident, stages, groups), card_layer_stream_plan with (1,
    out_f32, resident, stages, 0)."""
    asked = []

    def fake_max(source, index, instance, hsz, cluster, rows):
        asked.append((source, instance[:2], instance[4]))
        return stub_occupancy(hsz, cluster, rows, *instance[2:4])

    monkeypatch.setattr(tl, "_max_clusters", fake_max)
    dev = torch.device("cuda", 0)
    try:
        plan = tl.card_unrolled_stream_plan(dev, 768, 2056, 4)
        assert plan == tl.plan_unrolled_stream(768, 2056, 4,
                                               _unrolled_occupancy)
        assert {a[:2] for a in asked} == {("lstm_staged_stream", (4, 0))}
        assert {a[2] for a in asked} == set(tl.UNROLL_STREAM_GROUPS)
        asked.clear()
        plan = tl.card_layer_stream_plan(dev, 768, 2056, 34, torch.float32)
        assert plan == tl.plan_layer_stream(768, 2056, 34, stub_occupancy)
        assert set(asked) == {("lstm_staged_stream", (1, 1), 0)}
    finally:
        tl.card_unrolled_stream_plan.cache_clear()
        tl.card_layer_stream_plan.cache_clear()


def _fake(fn_name, *args, plan=None):
    if fn_name.startswith("lstm_layer_fwd"):
        return layer_fake_launch(fn_name, *args, plan=plan)
    return variants_fake_launch(fn_name, *args, plan=plan)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with the fakes of
    tests/test_torch_lstm_layer.py and tests/test_torch_lstm_variants.py
    (dispatched by name) and the streamed plans of the stub occupancy."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", _fake)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


def _counted(counts, entry, fn):
    for name in counts:
        counts[name] = 0
    out = fn()
    assert counts == {**dict.fromkeys(counts, 0), entry: 1}
    return out


def _on_cpu(fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        return fn()


def _layer_inputs(t_len, b, f, hsz, seed):
    return [torch.from_numpy(a) for a in (
        _rand((t_len, b, f), seed), _rand((f, 4 * hsz), seed + 1, 0.05),
        _rand((hsz, 4 * hsz), seed + 2, 0.03), _rand((4 * hsz,), seed + 3,
                                                     0.1))]


@pytest.mark.parametrize("f", [34, 33, 640])
def test_layer_kernel_branch_equals_the_cpu_branch(launches, f):
    """lstm_layer_tm at H=640 (padded for the streamed cluster, F odd
    padded to even): one lstm_layer_fwd_stream a call, forward and reverse,
    bf16 and fp32 out, equal to the CPU branch; under streamed_forwards() at
    H=384 the same against the cluster's CPU branch."""
    for hsz in (640, 384):
        args = _layer_inputs(3, 9, f, hsz, seed=f + hsz)
        for reverse in (False, True):
            for out_dtype in (torch.bfloat16, torch.float32):
                with torch.no_grad(), (tl.streamed_forwards() if hsz == 384
                                       else torch.no_grad()):
                    got = _counted(launches, "lstm_layer_fwd_stream",
                                   lambda: tl.lstm_layer_tm(
                                       *args, reverse, out_dtype))
                want = _on_cpu(lambda: tl.lstm_layer_tm(*args, reverse,
                                                        out_dtype))
                assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("k", [2, 4])
def test_unrolled_kernel_branch_equals_the_cpu_branch(launches, k):
    """lstm_scan_tm(..., block_t=k) and lstm_unrolled at H=640 and 1000
    (padded to stream_hidden's units): one lstm_scan_fwd_unrolled_stream a
    call, equal to the CPU branch and to lstm_scan_tm (kernel A's streamed
    cluster); the planned wrapper launches the plan it is given."""
    for hsz in (640, 1000):
        gates = _bf16(_rand((8, 9, 4 * hsz), hsz, 0.5))
        w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), hsz + 1, 0.02))
        got = _counted(launches, "lstm_scan_fwd_unrolled_stream",
                       lambda: tu.lstm_unrolled(gates, w_hh, block_t=k))
        with torch.no_grad():
            again = _counted(launches, "lstm_scan_fwd_unrolled_stream",
                             lambda: tl.lstm_scan_tm(gates, w_hh, block_t=k))
            kernel_a = _counted(launches, "lstm_scan_fwd_stream",
                                lambda: tl.lstm_scan_tm(gates, w_hh))
        want = _on_cpu(lambda: tu.lstm_unrolled(gates, w_hh, block_t=k))
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        assert torch.equal(again, want) and torch.equal(kernel_a, want)
    plan = tl.plan_unrolled_stream(640, 9, k, lambda *a: 1, resident=2)
    gates = _bf16(_rand((8, 9, 4 * 640), 72, 0.5))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_launch", lambda name, *a, plan=None: seen.append(
            (name, plan, stream_weight_rows(a[1], plan, 4).shape)))
        tl.lstm_scan_unrolled_planned_tm(gates, w_hh[:640, :2560], plan, k)
    assert seen == [("lstm_scan_fwd_unrolled_stream", plan, (2560, 640))]


@pytest.mark.parametrize("f", [34, 640])
@pytest.mark.parametrize("reverse", [False, True])
def test_layer_matches_pallas_interpret(launches, f, reverse):
    """The kernel branch (lstm_layer_fwd_stream) at H=640 with F=34 and
    F=H against the JAX lstm_layer_tm with its Pallas kernel in interpret
    mode, fp32 out."""
    hsz = 640
    x, wi, wh, bias = (_rand((4, 9, f), 60 + f), _rand((f, 4 * hsz), 61, 0.05),
                       _rand((hsz, 4 * hsz), 62, 0.03),
                       _rand((4 * hsz,), 63, 0.1))
    want = np.asarray(jl.lstm_layer_tm(x, wi, wh, bias, reverse, 256, True,
                                       jnp.float32))
    args = [torch.from_numpy(a) for a in (x, wi, wh, bias)]
    with torch.no_grad():
        got = _counted(launches, "lstm_layer_fwd_stream",
                       lambda: tl.lstm_layer_tm(*args, reverse,
                                                torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **BF16)


@pytest.mark.parametrize("k", [2, 4])
def test_unrolled_matches_script_interpret(launches, k):
    """The kernel branch (lstm_scan_fwd_unrolled_stream) at H=640 against
    the script's unrolled kernel in interpret mode (blocks of 8 rows)."""
    script = _load_script("perf_lstm_unroll")
    hsz = 640
    gates = jnp.asarray(_rand((4, 8, 4 * hsz), 70, 0.5), jnp.bfloat16)
    w_hh = _rand((hsz, 4 * hsz), 71, 0.2 * (16 / hsz) ** 0.5)
    want = np.asarray(_unrolled_interpret(script, gates, jnp.asarray(w_hh), 8,
                                          k), np.float32)
    got = _counted(launches, "lstm_scan_fwd_unrolled_stream",
                   lambda: tu.lstm_unrolled(_bf16(gates),
                                            torch.from_numpy(w_hh), k))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_stack_from_converted_weights_matches_pallas(launches):
    """A two-layer LSTM SequenceModel's params in the JAX layout (F=34 into
    H=640, then F=H), carried across by utils/convert.py: both layers
    through lstm_layer_tm's kernel branch (two lstm_layer_fwd_stream)
    against the JAX lstm_layer_tm in interpret mode over the same params,
    each side feeding its own layer-1 output on, fp32 out."""
    hsz, f = 640, 34
    params = convert._random_recurrent(np.random.default_rng(80), "LSTM", f,
                                       hsz, 2)
    sd = convert.convert_sequence_model(params, "", "LSTM")
    x = _rand((4, 9, f), 81)
    want = x
    for layer in range(2):
        p = params[f"layer_{layer}"]
        want = np.asarray(jl.lstm_layer_tm(
            want, p["w_ih"], p["w_hh"], p["b_ih"] + p["b_hh"], False, 256,
            True, jnp.float32))
    got = torch.from_numpy(x)
    for name in launches:
        launches[name] = 0
    with torch.no_grad():
        for layer in range(2):
            got = tl.lstm_layer_tm(
                got, sd[f"sequence_model.weight_ih_l{layer}"].t(),
                sd[f"sequence_model.weight_hh_l{layer}"].t(),
                sd[f"sequence_model.bias_ih_l{layer}"]
                + sd[f"sequence_model.bias_hh_l{layer}"], False,
                torch.float32)
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_layer_fwd_stream": 2}
    np.testing.assert_allclose(got.numpy(), want, **BF16)
