"""The two LSTM scan variants that the JAX package keeps as scripts, ported
as generative_audio_torch.scripts: the chains backward (perf_lstm_chains,
kernel G, csrc/lstm_scan_bwd.cu `lstm_scan_bwd_chains`) and the K-step
unrolled forward (perf_lstm_unroll, kernel E, csrc/lstm_scan_staged.cu
`lstm_scan_fwd_unrolled`), on the CPU against the scripts' own Pallas
kernels in interpret mode.

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
from test_torch_lstm_backward import (FORWARD_UNITS, fill, real_units,
                                      real_weight, strip)
from test_torch_lstm_backward import fake_launch as scan_fake_launch

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


def test_chains_bwd_matches_script_interpret():
    """The port's chains_bwd (plain, 2 chains) against the script's
    chains_bwd with 2 chains in interpret mode, on the script's own inputs
    (block_b = 8, so a 16-row padded batch; the port takes the first 13
    rows: a ragged count)."""
    script = _load_script("perf_lstm_chains")
    t_len, b, hsz, block_b = 6, 13, 16, 8
    gx, h, c, gout, whh = script.make_inputs(t_len, b, hsz, block_b,
                                             np.random.default_rng(0))
    want = np.asarray(script.chains_bwd(gx, h, c, gout, whh, block_b=block_b,
                                        n_chains=2, interpret=True),
                      np.float32)[:, :b]
    got = tc.chains_bwd(*(_bf16(a)[:, :b] for a in (gx, h, c, gout)),
                        torch.from_numpy(np.array(whh)), n_chains=2)
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


@pytest.mark.parametrize("block_t", [2, 4])
def test_lstm_unrolled_matches_script_interpret(block_t):
    """The port's lstm_unrolled (plain) against the script's unrolled
    kernel in interpret mode: T = 8, 16 rows in blocks of 8, H = 16."""
    script = _load_script("perf_lstm_unroll")
    t_len, b, hsz = 8, 16, 16
    gates = jnp.asarray(_rand((t_len, b, 4 * hsz), 1, 0.5), jnp.bfloat16)
    w_hh = _rand((hsz, 4 * hsz), 2, 0.2)
    want = np.asarray(_unrolled_interpret(script, gates, jnp.asarray(w_hh), 8,
                                          block_t), np.float32)
    got = tu.lstm_unrolled(_bf16(gates), torch.from_numpy(w_hh), block_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def fake_launch(fn_name, *args, plan=None):
    """Stands in for ops.lstm._launch where there is no card: kernels E and
    G compute what kernels A and D do, so each runs that plain version into
    the output buffer it was given, after checking the arguments the
    wrapper built (for kernel E, H zero-padded to the cluster's 64 units:
    the multiple and the zero units of its operands); the other kernels as
    tests/test_torch_lstm_backward.py fakes them."""
    if fn_name == "lstm_scan_fwd_unrolled":
        gates, wt, out, t_len, b, hp, k = args
        assert k in (2, 4) and t_len % k == 0 and out.dtype == torch.bfloat16
        assert tuple(out.shape) == (t_len, b, hp)
        assert tuple(gates.shape) == (t_len, b, 4 * hp)
        h = real_units(wt, 4, FORWARD_UNITS)
        fill(out, tl.lstm_scan_reference_tm(strip(gates, h, 4),
                                            real_weight(wt, h, 4)))
    elif fn_name == "lstm_scan_bwd_chains":
        gates, h_seq, c_seq, gout, wt, w, dgates, _, _, _, n_chains = args
        assert torch.equal(wt.t(), w) and n_chains in (2, 4)
        dgates.copy_(tl.lstm_scan_bwd_reference_tm(gates, h_seq, c_seq, gout,
                                                   w))
    else:
        return scan_fake_launch(fn_name, *args, plan=plan)
    tl.launch_counts[fn_name] += 1


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with fake_launch."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    return tl.launch_counts


def test_kernel_route_of_both_wrappers(launches):
    """On the kernels' branch each wrapper launches its own kernel once, and
    its result equals the CPU branch's and the kernel it reorganises."""
    inputs = tc.make_inputs(6, 37, 16, "cpu", seed=3)
    got = tc.chains_bwd(*inputs, n_chains=2)
    assert launches["lstm_scan_bwd_chains"] == 1
    assert torch.equal(got, tl.lstm_scan_bwd_tm(*inputs))
    gates, w_hh = inputs[0], inputs[4]
    for k in (2, 4):
        out = tu.lstm_unrolled(gates[:4], w_hh, block_t=k)
        assert torch.equal(out, tl.lstm_scan_tm(gates[:4], w_hh))
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_scan_bwd_chains": 1, "lstm_scan_bwd": 1,
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


def test_refusals(launches):
    """T % K, K other than 2 and 4, a chain count other than 2 and 4, and a
    block over the 227 KB shared-memory limit raise before any launch."""
    inputs = tc.make_inputs(6, 5, 16, "cpu", seed=4)
    gates, w_hh = inputs[0], inputs[4]
    with pytest.raises(ValueError, match="multiple"):
        tu.lstm_unrolled(gates[:5], w_hh, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tu.lstm_unrolled(gates, w_hh, block_t=3)
    with pytest.raises(ValueError, match="n_chains"):
        tc.chains_bwd(*inputs, n_chains=3)
    # H = 384: four chains take 444 416 B; H = 640: no cluster holds kernel
    # E's layout (a CTA of 16 at 16 rows and K=4 needs 292 496 B; at H = 512
    # it needs 201 360 B and launches)
    big = tc.make_inputs(2, 2, 384, "cpu", seed=5)
    with pytest.raises(ValueError, match="444416 B"):
        tc.chains_bwd(*big, n_chains=4)
    gates_640 = torch.zeros(4, 2, 4 * 640, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C=16: 292496 B at H=640"):
        tu.lstm_unrolled(gates_640, torch.zeros(640, 4 * 640), block_t=4)
    assert tl.unrolled_smem_bytes(512, 16, 16, 4) == 201360 <= tl.SMEM_LIMIT
    # kernel G has no reverse; kernel E is the forward inference scan only
    with pytest.raises(ValueError, match="n_chains"):
        tl.lstm_scan_bwd_tm(*inputs, reverse=True, n_chains=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh, reverse=True, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh, out_dtype=torch.float32, block_t=2)
    with pytest.raises(ValueError, match="block_t"):
        tl.lstm_scan_tm(gates[:4], w_hh.clone().requires_grad_(), block_t=2)
    # H = 512 (the full-band LSTM): two chains take 295 936 B
    fb = tc.make_inputs(2, 2, 512, "cpu", seed=6)
    with pytest.raises(ValueError, match="295936 B"):
        tc.chains_bwd(*fb, n_chains=2)
    assert not any(launches.values())
    # and two chains at H = 384 fit (222 208 B): the script's default
    assert tl.bwd_smem_bytes(384, 2) == 222208 <= tl.SMEM_LIMIT
