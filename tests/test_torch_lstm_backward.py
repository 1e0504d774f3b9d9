"""The training side of generative_audio_torch.ops.lstm on the CPU: the plain
versions of the training-forward and backward scan kernels, and the
autograd Function around them, against the JAX package's Pallas kernels run
in interpret mode (as tests/test_pallas_lstm.py runs them).

Both sides compute the same bf16 algorithm: bf16 gates, h, c, gout and
dgates streams, fp32 state and accumulation. They differ in the order of
the sums and in the transcendental functions, and a float32 difference that
crosses a bf16 rounding boundary moves that value by one bf16 step (2^-8
relative) and then propagates through the next product. So tolerances are
bf16 ones: 1e-2 absolute on h (in (-1, 1)) and on c and dgates (both O(1)
here) with 1e-2 relative on top; gradients against the exact float32
recurrence get the JAX tests' atol 2e-2 / rtol 1e-2.

torch.autograd.gradcheck is not applicable to LSTMScan: the bf16 roundings
make the function piecewise constant at gradcheck's step sizes, so a
finite-difference test could not pass. The exact-gradient comparison below
takes its place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import lstm as tl
from torch_stream_stubs import stub_stream_plans, unstream

torch.set_num_threads(2)
BF16 = dict(atol=1e-2, rtol=1e-2)
EXACT = dict(atol=2e-2, rtol=1e-2)
BLOCK = 16      # the Pallas calls take a batch padded to their block


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pad(x, b_pad):
    return np.pad(x, ((0, 0), (0, b_pad - x.shape[1]), (0, 0)))


def _pallas_residuals(gx, whh, reverse):
    """(padded bf16 gates, h_seq, c_seq) from the Pallas training forward."""
    b_pad = -(-gx.shape[1] // BLOCK) * BLOCK
    gx_pad = jnp.asarray(_pad(gx, b_pad), jnp.bfloat16)
    h_seq, c_seq = jl._lstm_pallas_call_train(gx_pad, whh, block_b=BLOCK,
                                              interpret=True, reverse=reverse)
    return gx_pad, h_seq, c_seq


CASES = [(13, 12, 16, False), (9, 8, 16, True), (5, 11, 32, False),
         (6, 11, 16, True)]     # batch 11: no multiple of 8


@pytest.mark.parametrize("t,b,h,reverse", CASES)
def test_train_forward_matches_pallas_interpret(t, b, h, reverse):
    gx = _rand((t, b, 4 * h), seed=1)
    whh = _rand((h, 4 * h), seed=2, scale=0.2)
    _, want_h, want_c = _pallas_residuals(gx, whh, reverse)
    got_h, got_c = tl.lstm_scan_train_tm(_bf16(gx), torch.from_numpy(whh),
                                         reverse)
    assert got_h.dtype == got_c.dtype == torch.bfloat16
    np.testing.assert_allclose(got_h.float().numpy(), _f32(want_h)[:, :b],
                               **BF16)
    np.testing.assert_allclose(got_c.float().numpy(), _f32(want_c)[:, :b],
                               **BF16)
    # h_seq is the inference scan's bf16 output, bit for bit
    with torch.no_grad():
        infer = tl.lstm_scan_tm(_bf16(gx), torch.from_numpy(whh), reverse)
    assert torch.equal(got_h, infer)


@pytest.mark.parametrize("t,b,h,reverse", CASES)
def test_backward_matches_pallas_interpret(t, b, h, reverse):
    """The plain backward scan against the Pallas backward kernel on the
    SAME residuals and cotangent."""
    gx = _rand((t, b, 4 * h), seed=3)
    whh = _rand((h, 4 * h), seed=4, scale=0.2)
    gx_pad, h_seq, c_seq = _pallas_residuals(gx, whh, reverse)
    gout = _rand((t, b, h), seed=5)
    gout_pad = jnp.asarray(_pad(gout, gx_pad.shape[1]), jnp.bfloat16)
    want = jl._lstm_pallas_call_bwd(gx_pad, h_seq, c_seq, gout_pad, whh,
                                    block_b=BLOCK, interpret=True,
                                    reverse=reverse)
    got = tl.lstm_scan_bwd_tm(_bf16(gx), _bf16(_f32(h_seq)[:, :b]),
                              _bf16(_f32(c_seq)[:, :b]), _bf16(gout),
                              torch.from_numpy(whh), reverse)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, b, 4 * h)
    np.testing.assert_allclose(got.float().numpy(), _f32(want)[:, :b], **BF16)
    # padded rows (zero gates, zero cotangent) give exactly zero dgates, so
    # a masked ragged tile and a padded one agree
    assert not np.any(_f32(want)[:, b:])


def _grad_cases():
    ct = _rand((6, 8, 8), seed=26)
    return {
        "reverse": ((7, 8, 8), (20, 21), True, None),
        "batch11": ((5, 11, 8), (22, 23), False, None),
        "cotangent": ((6, 8, 8), (24, 25), False, ct),
    }


def _torch_grads(fn, gx, whh, reverse, ct):
    g = torch.from_numpy(gx).requires_grad_()
    w = torch.from_numpy(whh).requires_grad_()
    y = fn(g, w, reverse)
    loss = (y * torch.from_numpy(ct)).sum() if ct is not None else (y ** 2).sum()
    loss.backward()
    return g.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("case", ["reverse", "batch11", "cotangent"])
def test_lstm_scan_gradients_match_jax(case):
    """LSTMScan (plain C and D on the CPU) against jax.grad through the
    Pallas training and backward kernels in interpret mode, and against the
    exact gradient of the float32 recurrence: the three cases of
    tests/test_pallas_lstm.py::TestPallasBackwardKernel."""
    (t, b, h), (s1, s2), reverse, ct = _grad_cases()[case]
    gx = _rand((t, b, 4 * h), seed=s1)
    whh = _rand((h, 4 * h), seed=s2, scale=0.2)

    def jax_loss(g_, w_):
        y = jl.lstm_scan_tm(g_, w_, reverse, 256, None, jnp.float32)
        return jnp.sum(y * ct) if ct is not None else jnp.sum(y ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1))(gx, whh)
    got = _torch_grads(
        lambda g, w, r: tl.lstm_scan_tm(g, w, r, torch.float32),
        gx, whh, reverse, ct)
    exact = _torch_grads(
        lambda g, w, r: tl.lstm_scan_reference_tm(
            g, w, r, compute_dtype=torch.float32), gx, whh, reverse, ct)
    for a, b_, e in zip(got, want, exact):
        assert a.dtype == np.float32 and a.shape == e.shape
        np.testing.assert_allclose(a, np.asarray(b_), **EXACT)
        np.testing.assert_allclose(a, e, **EXACT)


def test_chunked_layer_gradients_match_unchunked():
    """Under grad the chunked layer takes the full projection + LSTMScan, so
    its gradients equal the unchunked layer's exactly."""
    t, b, f, h = 11, 5, 6, 8
    x, wi, wh, bias = (_rand((t, b, f), 30), _rand((f, 4 * h), 31, 0.3),
                       _rand((h, 4 * h), 32, 0.2), _rand((4 * h,), 33, 0.1))

    def grads(chunked):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, wi, wh, bias)]
        tx, twi, twh, tb = ts
        if chunked:
            y = tl.lstm_layer_tm_chunked(tx, twi, twh, tb, False, 4,
                                         torch.float32)
        else:
            y = tl.lstm_scan_tm(tx @ twi + tb, twh, False, torch.float32)
        (y ** 2).sum().backward()
        return [a.grad for a in ts]

    for a, b_ in zip(grads(True), grads(False)):
        assert a is not None and torch.equal(a, b_)


# The units the wrappers pad H to a multiple of, per kernel: the cluster
# forward scans take 8-unit groups on each of 8 (or 16) CTAs, the other
# scans whole 16-deep k-steps (ops/lstm.py scan_hidden and _STEP_UNITS).
FORWARD_UNITS, BACKWARD_UNITS = 64, 16


def real_units(wt, n_gates, units):
    """The H of the layer whose W_hh^T [n*hp, hp] a wrapper handed a kernel:
    checks that hp is the least multiple of `units` at or above it and that
    the padded units' rows and columns are zero. (The random test weights
    have no zero unit.)"""
    hp = wt.shape[1]
    assert hp % units == 0 and wt.shape[0] == n_gates * hp
    used = (wt != 0).reshape(n_gates, hp, hp)     # [gate, out unit, in unit]
    hsz = int(torch.nonzero(used.any(0).any(0)).max()) + 1
    assert hp - hsz < units
    assert not used[:, hsz:].any() and not used[:, :, hsz:].any()
    return hsz


def strip(x, hsz, n=1):
    """x [..., n*hp] -> [..., n*hsz], after checking that the padded units of
    each of its n blocks are zero."""
    blocks = x.unflatten(-1, (n, x.shape[-1] // n))
    assert not blocks[..., hsz:].any()
    return blocks[..., :hsz].flatten(-2)


def real_weight(wt, hsz, n):
    """W_hh [hsz, n*hsz] from the kernel operand W_hh^T [n*hp, hp],
    contiguous as the CPU branch's weight: the CPU's matmul may sum a
    strided operand in another order."""
    return strip(wt.t()[:hsz], hsz, n).contiguous()


def fill(buf, value, n=1):
    """value [..., n*hsz] into the kernel's output buffer buf [..., n*hp],
    its padded units zero, as the kernel leaves them."""
    buf.zero_()
    buf.unflatten(-1, (n, buf.shape[-1] // n))[..., :value.shape[-1] // n] = \
        value.unflatten(-1, (n, value.shape[-1] // n))


def fake_launch(fn_name, *args, plan=None):
    """Stands in for ops.lstm._launch where there is no card: runs the
    kernel's plain version into the output buffers it was given, and counts
    the launch as _launch does. It checks the zero padding of H the wrapper
    handed the kernel and computes on the real units, as the kernel's zero
    units leave them unchanged. The single-block forwards ("_block") take
    the cluster entries' arguments at H padded to whole k-steps; the
    streamed ones ("_stream", forwards and the backward) and the wide ones
    of kernels A, B, C and D ("_wide") the cluster entries' with W_hh
    packed for their plan (`plan=`), at H padded to stream_hidden's
    units."""
    tl.launch_counts[fn_name] += 1
    units, bwd_units = FORWARD_UNITS, BACKWARD_UNITS
    if fn_name.endswith("_block"):
        fn_name, units = fn_name[:-len("_block")], BACKWARD_UNITS
    elif fn_name.endswith(("_stream", "_wide")):
        fn_name, args, units = unstream(fn_name, args, plan, 4)
        bwd_units = units
    if fn_name == "lstm_scan_fwd":
        gates, wt, out, _, _, _, _, reverse = args
        h = real_units(wt, 4, units)
        fill(out, tl.lstm_scan_reference_tm(strip(gates, h, 4),
                                            real_weight(wt, h, 4),
                                            bool(reverse)))
    elif fn_name == "lstm_scan_fwd_carry":
        gates, wt, h0, c0, out, h_t, c_t, _, _, _, _, reverse = args
        h = real_units(wt, 4, units)
        seq, hn, cn = tl.lstm_scan_carry_reference_tm(
            strip(gates, h, 4), real_weight(wt, h, 4), strip(h0, h),
            strip(c0, h), bool(reverse), out.dtype)
        fill(out, seq), fill(h_t, hn), fill(c_t, cn)
    elif fn_name == "lstm_scan_fwd_train":
        gates, wt, h_seq, c_seq, _, _, _, reverse = args
        h = real_units(wt, 4, units)
        hs, cs = tl.lstm_scan_train_reference_tm(
            strip(gates, h, 4), real_weight(wt, h, 4), bool(reverse))
        fill(h_seq, hs), fill(c_seq, cs)
    elif fn_name == "lstm_scan_bwd":
        gates, h_seq, c_seq, gout, wt, w, wf, dgates, _, _, _, reverse = args
        assert torch.equal(wt.t(), w) and torch.equal(wf,
                                                      tl._fragment_weight(wt))
        h = real_units(wt, 4, bwd_units)
        fill(dgates, tl.lstm_scan_bwd_reference_tm(
            strip(gates, h, 4), strip(h_seq, h), strip(c_seq, h),
            strip(gout, h), real_weight(wt, h, 4), bool(reverse)), 4)
    else:
        raise KeyError(fn_name)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with fake_launch and
    the streamed forwards' plans from stub_occupancy."""
    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


def test_grad_inputs_get_a_grad_fn():
    """The scan of inputs that require grad is part of the graph (it was
    not when the wrapper wrote the kernel's result into a fresh buffer)."""
    gx = torch.from_numpy(_rand((4, 3, 64), seed=40)).requires_grad_()
    whh = torch.from_numpy(_rand((16, 64), seed=41, scale=0.2)).requires_grad_()
    for out_dtype in (torch.bfloat16, torch.float32):
        y = tl.lstm_scan_tm(gx, whh, out_dtype=out_dtype)
        assert y.grad_fn is not None and y.dtype == out_dtype
    with torch.no_grad():
        assert tl.lstm_scan_tm(gx, whh).grad_fn is None


def test_kernel_route_by_grad_mode(launches):
    """On the kernels' branch: grad -> one training forward and, in
    backward, one backward scan; no_grad -> the inference kernel only. The
    results equal the CPU branch's, so the wrappers pass the kernels the
    right operands in the right order."""
    gx = _rand((5, 7, 64), seed=42)
    whh = _rand((16, 64), seed=43, scale=0.2)
    for reverse in (False, True):
        for name in launches:
            launches[name] = 0
        got = _torch_grads(lambda g, w, r: tl.lstm_scan_tm(g, w, r), gx, whh,
                           reverse, None)
        assert launches == {**dict.fromkeys(launches, 0),   # GRU ones too
                            "lstm_scan_fwd_train": 1, "lstm_scan_bwd": 1}
        with torch.no_grad():
            tl.lstm_scan_tm(torch.from_numpy(gx), torch.from_numpy(whh),
                            reverse)
        assert launches["lstm_scan_fwd"] == 1
        assert launches["lstm_scan_fwd_train"] == 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tl, "_is_cuda", lambda *tensors: False)
            want = _torch_grads(lambda g, w, r: tl.lstm_scan_tm(g, w, r), gx,
                                whh, reverse, None)
        for a, b_ in zip(got, want):
            np.testing.assert_array_equal(a, b_)


def test_kernel_operands_are_checked(launches):
    gates = _bf16(_rand((3, 2, 64), seed=44))
    whh = torch.from_numpy(_rand((16, 64), seed=45, scale=0.2))
    state = torch.zeros(3, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tl.lstm_scan_train_tm(gates.float(), whh)
    with pytest.raises(TypeError):
        tl.lstm_scan_bwd_tm(gates, state, state, state.float(), whh)
    with pytest.raises(ValueError):
        tl.lstm_scan_bwd_tm(gates, state, state[:2], state, whh)
    assert not any(launches.values())
    # no cluster of 16 holds the W_hh slice of H = 1024 in shared memory, so
    # the training forward takes the streamed cluster (part of the slice
    # from L2 at every step), as the JAX kernels take any H
    big = _bf16(_rand((2, 1, 4 * 1024), seed=46))
    w_big = torch.from_numpy(_rand((1024, 4 * 1024), seed=47, scale=0.02))
    got = tl.lstm_scan_train_tm(big, w_big)
    assert launches == {**dict.fromkeys(launches, 0),
                        "lstm_scan_fwd_train_stream": 1}
    want = tl.lstm_scan_train_reference_tm(big, w_big)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
