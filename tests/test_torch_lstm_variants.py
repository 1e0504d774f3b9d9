"""The two LSTM scan variants that the JAX package keeps as scripts, ported
as generative_audio_torch.scripts: the chains backward (perf_lstm_chains,
kernel G, csrc/lstm_scan_bwd_chains.cu `lstm_scan_bwd_chains`, and its
single block csrc/lstm_scan_bwd.cu `lstm_scan_bwd_chains_block`) and the
K-step unrolled forward (perf_lstm_unroll, kernel E,
csrc/lstm_scan_staged.cu `lstm_scan_fwd_unrolled`, and its single block
csrc/lstm_scan_unrolled_block.cu `lstm_scan_fwd_unrolled_block`), on the
CPU against the scripts' own Pallas kernels in interpret mode.

The scripts are loaded from scripts/ by file path (scripts/ is no package;
perf_lstm_unroll.py imports its neighbour _perf_common), and sys.path and
os.environ are restored afterwards, since both scripts change them when
imported. perf_lstm_unroll.py has no interpret flag, so the test builds the
script's pallas_call around its `_unroll_kernel` with the script's
BlockSpecs and interpret=True.

Both sides compute the same bf16 algorithm (bf16 gates, h and dgates
streams, fp32 state and accumulation) and differ in the order of the sums
and in the transcendental functions; a difference that crosses a bf16
rounding boundary moves a value by one bf16 step (2^-8 relative). So the
tolerance is a bf16 one: 1e-2 absolute and relative, as in
tests/test_torch_lstm_backward.py.
"""
import functools
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_torch.ops import lstm as tl
from generative_audio_torch.scripts import perf_lstm_chains as tc
from generative_audio_torch.scripts import perf_lstm_unroll as tu
from test_torch_lstm_backward import (BACKWARD_UNITS, FORWARD_UNITS, fill,
                                      real_units, real_weight, strip)
from test_torch_lstm_backward import fake_launch as scan_fake_launch
from torch_stream_stubs import stream_weight_rows, stub_stream_plans

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load_script(name):
    """scripts/<name>.py as a module, with scripts/ on sys.path for its own
    imports; sys.path and os.environ as they were afterwards."""
    path, env = list(sys.path), dict(os.environ)
    sys.path.insert(0, str(SCRIPTS))
    try:
        spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                      SCRIPTS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("t_len,b,hsz,n_chains", [
    (6, 13, 16, 2), (5, 11, 20, 2), (4, 9, 20, 4)])
def test_chains_bwd_matches_script_interpret(t_len, b, hsz, n_chains):
    """The port's chains_bwd (plain) against the script's chains_bwd in
    interpret mode, on the script's own inputs (block_b = 8, a padded batch;
    the port takes the first b rows: a ragged count), at H=16 and at H=20,
    which the card's route pads to 32."""
    script = _load_script("perf_lstm_chains")
    block_b = 8
    gx, h, c, gout, whh = script.make_inputs(t_len, b, hsz, block_b,
                                             np.random.default_rng(0))
    want = np.asarray(script.chains_bwd(gx, h, c, gout, whh, block_b=block_b,
                                        n_chains=n_chains, interpret=True),
                      np.float32)[:, :b]
    got = tc.chains_bwd(*(_bf16(a)[:, :b] for a in (gx, h, c, gout)),
                        torch.from_numpy(np.array(whh)), n_chains=n_chains)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def _unrolled_interpret(script, gates, w_hh, block_b, block_t):
    """The script's lstm_unrolled, built around its _unroll_kernel with its
    BlockSpecs, in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    t_len, b_pad, g4 = gates.shape
    hsz = g4 // 4

    def time_map(b, t):
        return (t, b, 0)

    return pl.pallas_call(
        functools.partial(script._unroll_kernel, block_t),
        grid=(b_pad // block_b, t_len // block_t),
        in_specs=[
            pl.BlockSpec((block_t, block_b, g4), time_map,
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((hsz, g4), lambda b, t: (0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((block_t, block_b, hsz), time_map,
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((t_len, b_pad, hsz), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((block_b, hsz), jnp.float32),
                        pltpu.VMEM((block_b, hsz), jnp.float32)],
        interpret=True,
    )(gates, w_hh.astype(jnp.bfloat16))


@pytest.mark.parametrize("t_len,b,hsz,block_t", [
    (8, 16, 16, 2), (8, 16, 16, 4), (4, 8, 640, 2), (4, 8, 640, 4)])
def test_lstm_unrolled_matches_script_interpret(t_len, b, hsz, block_t):
    """The port's lstm_unrolled (plain) against the script's unrolled
    kernel in interpret mode, in blocks of 8 rows: at H = 16, and at H = 640,
    where the card takes kernel E's single block."""
    script = _load_script("perf_lstm_unroll")
    gates = jnp.asarray(_rand((t_len, b, 4 * hsz), 1, 0.5), jnp.bfloat16)
    w_hh = _rand((hsz, 4 * hsz), 2, 0.2 * (16 / hsz) ** 0.5)
    want = np.asarray(_unrolled_interpret(script, gates, jnp.asarray(w_hh), 8,
                                          block_t), np.float32)
    got = tu.lstm_unrolled(_bf16(gates), torch.from_numpy(w_hh), block_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


ASKED = []     # (H, rows, n_chains) of every kernel G plan asked for


def h100_clusters(cluster, rows, resident=False, arrangement=0):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM."""
    return 15 if cluster == 8 else 7


def fake_launch(fn_name, *args, plan=None):
    """Stands in for ops.lstm._launch where there is no card: kernels E and
    G compute what kernels A and D do, so each runs that plain version into
    the output buffer it was given, after checking the arguments the
    wrapper built (H zero-padded: for kernel E's cluster to its 64 units,
    for its streamed cluster to stream_hidden's, for its single block and
    for kernel G to 16; the multiple and the zero units of the operands; the
    plan, the streamed cluster's W_hh^T packed for its plan and the plan's
    shared bytes, or the single block's rows and shared bytes); the other
    kernels as tests/test_torch_lstm_backward.py fakes them."""
    if fn_name == "lstm_scan_fwd_unrolled":
        gates, wt, out, t_len, b, hp, k = args
        h = real_units(wt, 4, FORWARD_UNITS)
    elif fn_name == "lstm_scan_fwd_unrolled_stream":
        gates, wf, out, t_len, b, hp, k = args
        assert isinstance(plan, tl.UnrolledStreamPlan) and plan.hidden == hp
        assert plan.smem_bytes == tl.unrolled_stream_smem_bytes(
            hp, plan.cluster, plan.rows, k, plan.resident, plan.stages,
            plan.groups) <= tl.SMEM_LIMIT
        wt = stream_weight_rows(wf, plan, 4)
        h = real_units(wt, 4, tl.stream_hidden(1, plan.cluster))
    elif fn_name == "lstm_scan_fwd_unrolled_block":
        gates, wt, out, t_len, b, hp, k, rows, smem = args
        h = real_units(wt, 4, BACKWARD_UNITS)
        assert rows == tl.unrolled_block_rows(hp, k)
        assert smem == tl.unrolled_block_smem_bytes(hp, rows, k)
        assert hp == -(-h // 16) * 16
    elif fn_name in ("lstm_scan_bwd_chains", "lstm_scan_bwd_chains_block"):
        if fn_name == "lstm_scan_bwd_chains":
            gates, h_seq, c_seq, gout, w, wf, dgates, _, b, hp, n_chains = args
            wt = w.t().contiguous()
            assert torch.equal(wf, tl._fragment_weight(wt))
            assert plan.design == "cluster" and plan.chains == n_chains
            assert plan.smem_bytes == tl.chains_cluster_smem_bytes(
                hp, plan.cluster, plan.rows, plan.resident)
            assert tl.chain_warps(plan.rows // 16, hp // plan.cluster // 8,
                                  n_chains, plan.arrangement)[1] == n_chains
        else:
            (gates, h_seq, c_seq, gout, wt, w, dgates, _, b, hp, n_chains,
             smem) = args
            assert torch.equal(wt.t(), w) and plan is None
            assert smem == tl.bwd_smem_bytes(hp, n_chains) <= tl.SMEM_LIMIT
        assert n_chains in (2, 4)
        h = real_units(wt, 4, BACKWARD_UNITS)
        # the weight contiguous, as the plain version's caller hands it: the
        # CPU's matmul may sum in another order for a strided operand
        fill(dgates, tl.lstm_scan_bwd_reference_tm(
            strip(gates, h, 4), strip(h_seq, h), strip(c_seq, h),
            strip(gout, h), real_weight(wt, h, 4).contiguous()), 4)
    else:
        return scan_fake_launch(fn_name, *args, plan=plan)
    if fn_name.startswith("lstm_scan_fwd_unrolled"):
        assert k in (2, 4) and t_len % k == 0 and out.dtype == torch.bfloat16
        assert tuple(out.shape) == (t_len, b, hp)
        assert tuple(gates.shape) == (t_len, b, 4 * hp)
        fill(out, tl.lstm_scan_reference_tm(
            strip(gates, h, 4), real_weight(wt, h, 4).contiguous()))
    tl.launch_counts[fn_name] += 1


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with fake_launch and
    kernel G's plans from an H100's occupancy."""
    ASKED.clear()

    def card_chains_plan(device, hsz, batch, n_chains):
        ASKED.append((hsz, batch, n_chains))
        return tl.plan_chains_scan(hsz, batch, n_chains, h100_clusters)

    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "card_chains_scan_plan", card_chains_plan)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


def test_kernel_route_of_both_wrappers(launches):
    """On the kernels' branch each wrapper launches its own kernel once, and
    its result equals the CPU branch's and the kernel it reorganises (at
    H=16 no cluster takes kernel G: its single block runs)."""
    inputs = tc.make_inputs(6, 37, 16, "cpu", seed=3)
    got = tc.chains_bwd(*inputs, n_chains=2)
    assert launches["lstm_scan_bwd_chains_block"] == 1
    assert ASKED == [(16, 37, 2)]
    assert torch.equal(got, tl.lstm_scan_bwd_tm(*inputs))
    gates, w_hh = inputs[0], inputs[4]
    for k in (2, 4):
        out = tu.lstm_unrolled(gates[:4], w_hh, block_t=k)
        assert torch.equal(out, tl.lstm_scan_tm(gates[:4], w_hh))
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_scan_bwd_chains_block": 1, "lstm_scan_bwd": 1,
                        "lstm_scan_fwd_unrolled": 2, "lstm_scan_fwd": 2}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        assert torch.equal(tc.chains_bwd(*inputs), got)
        assert torch.equal(tu.lstm_unrolled(gates[:4], w_hh), out)


@pytest.mark.parametrize("hsz", [20, 100])
def test_lstm_unrolled_pads_the_hidden_size(launches, hsz):
    """H = 20 and 100 on the kernel's branch: kernel E runs at H padded to
    the cluster's 64 units (the fake checks them) and equals lstm_scan_tm
    (kernel A, padded the same way) and the CPU branch."""
    gates = _bf16(_rand((8, 11, 4 * hsz), 8, 0.5))
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), 9, 0.2))
    for k in (2, 4):
        got = tu.lstm_unrolled(gates, w_hh, block_t=k)
        assert tuple(got.shape) == (8, 11, hsz)
        assert torch.equal(got, tl.lstm_scan_tm(gates, w_hh))
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_scan_fwd_unrolled": 2, "lstm_scan_fwd": 2}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        assert torch.equal(tu.lstm_unrolled(gates, w_hh), got)


@pytest.mark.parametrize("hsz,n_chains,design", [
    (384, 4, "cluster"), (512, 2, "cluster"), (20, 2, "block")])
def test_refusals(launches, hsz, n_chains, design):
    """The shapes the chains backward refused before (H % 16, and the
    shared memory of its single block: four chains at H=384 took 444 416 B,
    two at H=512 295 936 B) now run through the card's branch: each hands
    its entry a plan (kernel G's cluster at H=384 and 512, its single block
    at H=20, padded to 32) and gives kernel D's plain dgates. What stays
    refused raises before any launch: T % K, K other than 2 and 4, a chain
    count other than 2 and 4, kernel G's reverse, and kernel E's reverse,
    fp32 output and grad."""
    inputs = tc.make_inputs(3, 18, hsz, "cpu", seed=4)
    got = tc.chains_bwd(*inputs, n_chains=n_chains)
    hp = -(-hsz // 16) * 16
    assert ASKED == [(hp, 18, n_chains)]
    plan = tl.plan_chains_scan(hp, 18, n_chains, h100_clusters)
    assert plan.design == design and plan.chains == n_chains
    entry = ("lstm_scan_bwd_chains" if design == "cluster"
             else "lstm_scan_bwd_chains_block")
    assert launches == {**dict.fromkeys(launches, 0), entry: 1}
    assert torch.equal(got, tc.chains_bwd_reference(*inputs))
    assert tuple(got.shape) == (3, 18, 4 * hsz)

    small = tc.make_inputs(6, 5, 16, "cpu", seed=5)
    gates, w_hh = small[0], small[4]
    with pytest.raises(ValueError, match="multiple"):
        tu.lstm_unrolled(gates[:5], w_hh, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tu.lstm_unrolled(gates, w_hh, block_t=3)
    with pytest.raises(ValueError, match="n_chains"):
        tc.chains_bwd(*small, n_chains=3)
    with pytest.raises(ValueError, match="n_chains"):
        tl.lstm_scan_bwd_tm(*small, reverse=True, n_chains=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh, reverse=True, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh, out_dtype=torch.float32, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh.clone().requires_grad_(), block_t=2)
    assert launches == {**dict.fromkeys(launches, 0), entry: 1}


@pytest.mark.parametrize("k", [2, 4])
def test_lstm_unrolled_above_what_a_cluster_holds(launches, k):
    """Kernel E at H=640, which no cluster holds: on the CPU it equals
    kernel A's plain version; on the card's branch it launches its streamed
    cluster (W_hh^T packed for its plan, the plan's shared bytes checked by
    the fake) and, within single_block_forwards(), its single block (rows
    and shared bytes checked), each giving the same h as lstm_scan_tm,
    which takes lstm_scan_fwd_stream (and lstm_scan_fwd_block)."""
    hsz = 640
    gates = _bf16(_rand((4, 9, 4 * hsz), 10, 0.5))
    w_hh = torch.from_numpy(_rand((hsz, 4 * hsz), 11, 0.02))
    got = tu.lstm_unrolled(gates, w_hh, block_t=k)
    with tl.single_block_forwards():
        blk = tu.lstm_unrolled(gates, w_hh, block_t=k)
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_scan_fwd_unrolled_stream": 1,
                        "lstm_scan_fwd_unrolled_block": 1}
    assert torch.equal(got, tl.lstm_scan_reference_tm(gates, w_hh).to(
        torch.bfloat16)) and torch.equal(blk, got)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        assert torch.equal(tu.lstm_unrolled(gates, w_hh, block_t=k), got)
