"""generative_audio_torch.ops.lstm's layer with the input projection inside
the scan (lstm_layer_tm; kernel F, csrc/lstm_scan_staged.cu
`lstm_layer_fwd`) and its gradient (LSTMLayerScan) on the CPU, against the
JAX package's lstm_layer_tm with its Pallas kernels in interpret mode, as
tests/test_pallas_lstm.py runs them.

Both sides compute x_t @ W_ih + bf16(h) @ W_hh + bias with bf16 x and
weights, fp32 accumulation, fp32 bias and c; they differ in the order of
the sums and in the transcendental functions, and a float32 difference that
moves h across a bf16 rounding boundary changes that h by one bf16 step
(2^-8 relative) for the next product. So the forward tolerance is a bf16
one: 1e-2 absolute and relative on h, which lies in (-1, 1). Gradients (bf16
gates, h, c and dgates streams on both sides) get the same 1e-2, and
against the exact float32 gradient the JAX layer test's atol 3e-2 / rtol
2e-2. Plain versions against the JAX float32 references compute the same
roundings and differ only by the order of float32 sums: 1e-5.

Shapes are tiny and ragged: T = 6, B = 9 rows (no multiple of 8 or 16),
F = 6 features (no multiple of 16), H = 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import lstm as tl
from test_torch_lstm_backward import (BACKWARD_UNITS, FORWARD_UNITS, fill,
                                      real_units, real_weight, strip)
from test_torch_lstm_backward import fake_launch as scan_fake_launch
from test_torch_staged_plan import unfragment
from torch_stream_stubs import stream_weight_rows, stub_stream_plans

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
EXACT = dict(atol=3e-2, rtol=2e-2)
F32 = dict(atol=1e-5, rtol=1e-5)
T, B, F, H = 6, 9, 6, 16


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _inputs(seed, f=F):
    return (_rand((T, B, f), seed), _rand((f, 4 * H), seed + 1, 0.3),
            _rand((H, 4 * H), seed + 2, 0.2), _rand((4 * H,), seed + 3, 0.1))


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_matches_pallas_interpret(reverse):
    """The wrapper's CPU branch (the plain version of kernel F) against the
    Pallas layer kernel in interpret mode; bf16 output is the float32 output
    rounded once."""
    x, wi, wh, bias = _inputs(10)
    want = np.asarray(jl.lstm_layer_tm(x, wi, wh, bias, reverse, 256, True,
                                       jnp.float32))
    args = [torch.from_numpy(a) for a in (x, wi, wh, bias)]
    got = tl.lstm_layer_tm(*args, reverse, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, B, H)
    np.testing.assert_allclose(got.numpy(), want, **BF16)
    assert torch.equal(tl.lstm_layer_tm(*args, reverse),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("reverse", [False, True])
def test_float32_plain_version_matches_float32_layer(reverse):
    """compute_dtype=float32: the JAX `_layer_reference`'s projection and
    the float32 lax.scan recurrence."""
    x, wi, wh, bias = _inputs(20)
    gates = jnp.einsum("tbf,fg->tbg", x, wi) + bias
    want = np.asarray(jl.lstm_scan_reference_tm(gates, wh, reverse,
                                                compute_dtype=jnp.float32))
    got = tl.lstm_layer_reference_tm(
        *(torch.from_numpy(a) for a in (x, wi, wh, bias)), reverse,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_layer_reference_is_a_bf16_recurrence():
    """The JAX `_layer_reference` rounds h and W_hh to bf16 in its
    recurrence (lstm_scan_reference_tm's default compute dtype): it is the
    port's float32 projection followed by the plain version of kernel A."""
    x, wi, wh, bias = _inputs(24)
    want = np.asarray(jl._layer_reference(x, wi, wh, bias, False))
    gates = torch.from_numpy(x) @ torch.from_numpy(wi) + torch.from_numpy(bias)
    got = tl.lstm_scan_reference_tm(gates, torch.from_numpy(wh))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _torch_grads(fn, arrays, ct):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*ts) * torch.from_numpy(ct)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_gradients_match_jax(reverse):
    """LSTMLayerScan (hoisted projection, plain kernels C and D) against
    jax.grad of the JAX lstm_layer_tm, whose VJP runs the Pallas training
    forward and backward kernels in interpret mode, and against the exact
    gradient of the float32 layer."""
    arrays = _inputs(30)
    ct = _rand((T, B, H), 34)

    def jax_loss(*a):
        return jnp.sum(jl.lstm_layer_tm(*a, reverse, 256, True, jnp.float32)
                       * ct)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*arrays)
    got = _torch_grads(lambda *a: tl.lstm_layer_tm(*a, reverse, torch.float32),
                       arrays, ct)
    exact = _torch_grads(lambda *a: tl.lstm_layer_reference_tm(
        *a, reverse, compute_dtype=torch.float32), arrays, ct)
    for a, b_, e, arr in zip(got, want, exact, arrays):
        assert a.dtype == np.float32 and a.shape == arr.shape
        np.testing.assert_allclose(a, np.asarray(b_), **BF16)
        np.testing.assert_allclose(a, e, **EXACT)


def fake_launch(fn_name, *args, plan=None):
    """Stands in for ops.lstm._launch where there is no card: kernel F's
    plain version into the output buffer it was given, after checking the
    operand layout the wrapper built: x with an even F; H zero-padded to
    the cluster's units (64), for the single block ("_block") to 16, for
    the streamed cluster ("_stream") to stream_hidden's, in W_hh^T, W_ih^T
    and the fp32 bias; W_ih^T with zero columns to a multiple of 32 and in
    fragment order for the clusters, of 16 as rows for the single block;
    the streamed cluster's W_hh^T packed for the plan it is handed, whose
    shared bytes are its layout's. The scan kernels as
    tests/test_torch_lstm_backward.py fakes them."""
    if fn_name not in ("lstm_layer_fwd", "lstm_layer_fwd_block",
                       "lstm_layer_fwd_stream"):
        return scan_fake_launch(fn_name, *args, plan=plan)
    x, w_in, wt, bias, out, out_f32, t_len, b, f, hp, reverse = args
    block = fn_name.endswith("_block")
    units = BACKWARD_UNITS if block else FORWARD_UNITS
    if fn_name.endswith("_stream"):
        assert type(plan) is tl.StreamPlan and plan.hidden == hp
        assert plan.smem_bytes == tl.layer_stream_smem_bytes(
            hp, plan.cluster, plan.rows, plan.resident, plan.stages
        ) <= tl.SMEM_LIMIT
        wt = stream_weight_rows(wt, plan, 4)
        units = tl.stream_hidden(1, plan.cluster)
    hsz = real_units(wt, 4, units)
    f_pad = -(-f // (16 if block else 32)) * (16 if block else 32)
    wih_t = w_in if block else unfragment(w_in, 4 * hp, f_pad)
    assert x.dtype == wih_t.dtype == wt.dtype == torch.bfloat16
    assert bias.dtype == torch.float32 and out_f32 == (out.dtype == torch.float32)
    assert tuple(x.shape) == (t_len, b, f) and f % 2 == 0
    assert tuple(wih_t.shape) == (4 * hp, f_pad)
    assert tuple(out.shape) == (t_len, b, hp) and tuple(bias.shape) == (4 * hp,)
    assert not wih_t[:, f:].any()
    assert w_in.is_contiguous() and x.is_contiguous()
    assert all(a.data_ptr() % 16 == 0 for a in (x, w_in, wt, bias, out))
    # both weights contiguous, as the CPU branch hands them: the CPU's
    # matmul may sum a strided operand in another order
    fill(out, tl.lstm_layer_reference_tm(
        x, strip(wih_t[:, :f].t(), hsz, 4).contiguous(),
        real_weight(wt, hsz, 4), strip(bias, hsz, 4), bool(reverse)))
    tl.launch_counts[fn_name] += 1


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with fake_launch."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


@pytest.mark.parametrize("f", [F, 5])       # 5: odd, padded to 6 for the kernel
def test_kernel_route_and_operands(launches, f):
    """On the kernel's branch: no grad -> one lstm_layer_fwd with the padded
    operands; grad -> LSTMLayerScan, one training forward and one backward
    scan and no lstm_layer_fwd. Each result equals the CPU branch's."""
    arrays = _inputs(40, f)
    ct = _rand((T, B, H), 44)
    for reverse in (False, True):
        for name in launches:
            launches[name] = 0
        args = [torch.from_numpy(a) for a in arrays]
        with torch.no_grad():
            got = tl.lstm_layer_tm(*args, reverse, torch.float32)
        assert launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 1}
        grads = _torch_grads(lambda *a: tl.lstm_layer_tm(*a, reverse), arrays,
                             ct)
        assert launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 1,
                            "lstm_scan_fwd_train": 1, "lstm_scan_bwd": 1}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tl, "_is_cuda", lambda *tensors: False)
            want = tl.lstm_layer_tm(*args, reverse, torch.float32)
            want_grads = _torch_grads(
                lambda *a: tl.lstm_layer_tm(*a, reverse), arrays, ct)
        assert torch.equal(got, want)
        for a, b_ in zip(grads, want_grads):
            np.testing.assert_array_equal(a, b_)


def test_layer_operands_are_checked(launches):
    x, wi, wh, bias = (torch.from_numpy(a) for a in _inputs(50))
    with pytest.raises(ValueError):
        tl.lstm_layer_tm(x, wi[:, :32], wh, bias)
    with pytest.raises(ValueError):
        tl.lstm_layer_tm(x, wi, wh, bias[:32])
    with pytest.raises(ValueError):
        tl.lstm_layer_tm(x, wi, wh, bias, out_dtype=torch.float16)
    assert not any(launches.values())
    # H = 8, no multiple of 16, pads to the cluster's 64 units and launches
    small = (x, wi[:, :32], wh[:8, :32], bias[:32])
    with torch.no_grad():
        got = tl.lstm_layer_tm(*small, False, torch.float32)
    assert launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 1}
    assert tuple(got.shape) == (T, B, 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        assert torch.equal(got, tl.lstm_layer_tm(*small, False, torch.float32))


def _inputs_h(seed, hsz, f=F, t_len=T, b=B):
    return (_rand((t_len, b, f), seed), _rand((f, 4 * hsz), seed + 1, 0.3),
            _rand((hsz, 4 * hsz), seed + 2, 0.2),
            _rand((4 * hsz,), seed + 3, 0.1))


@pytest.mark.parametrize("hsz", [20, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_padded_hidden_on_the_kernel_branch(launches, hsz, reverse):
    """H = 20 and 100 on the kernel's branch: the wrapper pads H to the
    cluster's 64 units (the fake checks the multiple and the zero units of
    every operand) and slices the result back; it equals the CPU branch, and
    the JAX lstm_layer_tm in interpret mode within the bf16 tolerance."""
    x, wi, wh, bias = _inputs_h(70, hsz)
    args = [torch.from_numpy(a) for a in (x, wi, wh, bias)]
    with torch.no_grad():
        got = tl.lstm_layer_tm(*args, reverse, torch.float32)
    assert launches == {**dict.fromkeys(launches, 0), "lstm_layer_fwd": 1}
    assert tuple(got.shape) == (T, B, hsz)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        assert torch.equal(got, tl.lstm_layer_tm(*args, reverse,
                                                 torch.float32))
    want = np.asarray(jl.lstm_layer_tm(x, wi, wh, bias, reverse, 256, True,
                                       jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, **BF16)


def test_single_block_route_above_what_a_cluster_holds(launches):
    """At H = 520 no cluster holds W_hh's slice: the wrapper takes the
    streamed cluster (`lstm_layer_fwd_stream`, W_hh^T packed for its plan)
    and, within single_block_forwards(), the single block
    (`lstm_layer_fwd_block`) at H padded to 528, with W_ih^T as rows of
    16-padded columns; both equal the CPU branch."""
    x, wi, wh, bias = _inputs_h(80, 520, f=5, t_len=2, b=3)
    args = [torch.from_numpy(a) for a in (x, wi, wh, bias)]
    assert tl.layer_route(520, 6)[1] == "_stream"
    with torch.no_grad():
        got = tl.lstm_layer_tm(*args, True)
        with tl.single_block_forwards():
            assert tl.layer_route(520, 6) == (528, "_block", None)
            blk = tl.lstm_layer_tm(*args, True)
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_layer_fwd_stream": 1, "lstm_layer_fwd_block": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_is_cuda", lambda *tensors: False)
        want = tl.lstm_layer_tm(*args, True)
    assert torch.equal(got, want) and torch.equal(blk, want)


def test_operands_off_16_bytes_are_copied(launches):
    """A float32 bias that is a contiguous view 4 bytes off a 16-byte
    boundary (a slice of a packed parameter buffer) reaches the kernel as an
    aligned copy; the fake launch checks every operand's alignment."""
    x, wi, wh, bias = (torch.from_numpy(a) for a in _inputs(60))
    packed = torch.zeros(4 * H + 1)
    packed[1:] = bias
    view = packed[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    with torch.no_grad():
        got = tl.lstm_layer_tm(x, wi, wh, view, False, torch.float32)
    assert launches["lstm_layer_fwd"] == 1
    assert torch.equal(got, tl.lstm_layer_tm(x, wi, wh, bias, False,
                                             torch.float32))


def test_launch_refuses_an_operand_off_16_bytes():
    """The launch helper itself refuses a misaligned tensor before it builds
    or loads anything, so no wrapper can hand one to a kernel."""
    view = torch.zeros(4 * H + 1)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        tl._launch("lstm_layer_fwd", view, 0)
