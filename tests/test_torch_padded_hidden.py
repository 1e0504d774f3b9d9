"""Hidden sizes the CUDA scan kernels do not take as they are (H=20 and
H=100), on the CPU: every scan wrapper of the model paths zero-pads H to
the units its kernel takes (64 or 128 for the cluster forward scans, 16
for the backward scans and the GRU contraction) and slices the result back.

Three kinds of test, LSTM and GRU:
  * the kernels' branch (launches faked by tests/test_torch_lstm_backward.py
    and tests/test_torch_gru.py, whose fakes assert the multiple they are
    handed and the zeros of the padded units, and compute on the real ones)
    equals the CPU branch: forward, carry from a state, training forward,
    backward and the autograd Functions' gradients;
  * the kernels' branch against the JAX package's Pallas kernels in
    interpret mode, within the tolerances of tests/test_torch_lstm.py,
    tests/test_torch_lstm_backward.py and tests/test_torch_gru.py (bf16
    ones: a float32 difference that crosses a bf16 rounding boundary moves
    h by one bf16 step);
  * the plain versions on zero-padded operands, which is what the kernels
    compute: the padded units stay exactly zero and the real units agree
    with the unpadded run within the same bf16 tolerances (the CPU's matmul
    may sum the real terms in another order once the width changes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from test_torch_gru import fake_launch as gru_fake_launch
from test_torch_lstm_backward import fake_launch as lstm_fake_launch

torch.set_num_threads(2)
HIDDEN = [20, 100]
H_ATOL = 5e-3                       # GRU h, as tests/test_torch_gru.py
BF16 = dict(atol=1e-2, rtol=1e-2)   # LSTM h and c, dgates, dW_hh, db_hh
T, B = 5, 7                         # B is no multiple of 8 or 16
LSTM_BLOCK, GRU_BLOCK = 16, 8       # the Pallas calls' batch blocks


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pad_rows(x, block):
    b_pad = -(-x.shape[1] // block) * block
    return np.pad(x, ((0, 0), (0, b_pad - x.shape[1]), (0, 0)))


def _lstm(h, seed):
    return (_rand((T, B, 4 * h), seed), _rand((h, 4 * h), seed + 1, 0.2),
            _rand((T, B, h), seed + 2), _rand((B, h), seed + 3),
            _rand((B, h), seed + 4))


def _gru(h, seed):
    return (_rand((T, B, 3 * h), seed), _rand((h, 3 * h), seed + 1, 0.2),
            _rand((3 * h,), seed + 2, 0.1), _rand((T, B, h), seed + 3),
            _rand((B, h), seed + 4))


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of both cells' wrappers on CPU tensors, with the
    fakes of the two test files."""
    for mod, fake in ((tl, lstm_fake_launch), (tg, gru_fake_launch)):
        monkeypatch.setattr(mod, "_is_cuda", lambda *tensors: True)
        monkeypatch.setattr(mod, "_launch", fake)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    return tl.launch_counts


def _cpu(fn):
    """fn() on the CPU branch of both cells' wrappers."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tl, tg):
            mp.setattr(mod, "_is_cuda", lambda *tensors: False)
        return fn()


def _grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad for t in ts]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _counts(launches, **expect):
    return launches == {**dict.fromkeys(launches, 0), **expect}


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_branch_equals_cpu_branch(launches, h, reverse):
    gx, whh, gout, h0, c0 = _lstm(h, seed=10 * h)
    gates, w = _bf16(gx), torch.from_numpy(whh)
    state = torch.from_numpy(h0), torch.from_numpy(c0)

    def forward():
        with torch.no_grad():
            return tl.lstm_scan_tm(gates, w, reverse, torch.float32)

    def carry():
        return tl.lstm_scan_carry_tm(gates, w, *state, reverse, torch.float32)

    def train():
        return tl.lstm_scan_train_tm(gates, w, reverse)

    def backward():
        h_seq, c_seq = tl.lstm_scan_train_reference_tm(gates, w, reverse)
        return tl.lstm_scan_bwd_tm(gates, h_seq, c_seq, _bf16(gout), w,
                                   reverse)

    def grads():
        return _grads(lambda g, w_: tl.lstm_scan_tm(g, w_, reverse), gx, whh)

    for name, fn, kernels in (
            ("forward", forward, dict(lstm_scan_fwd=1)),
            ("carry", carry, dict(lstm_scan_fwd_carry=1)),
            ("train", train, dict(lstm_scan_fwd_train=1)),
            ("backward", backward, dict(lstm_scan_bwd=1)),
            ("grads", grads, dict(lstm_scan_fwd_train=1, lstm_scan_bwd=1))):
        for k in launches:
            launches[k] = 0
        got = _as_tuple(fn())
        assert _counts(launches, **kernels), (name, launches)
        want = _as_tuple(_cpu(fn))
        for a, b_ in zip(got, want):
            assert a.shape == b_.shape and a.dtype == b_.dtype, name
            assert torch.equal(a, b_), name


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_branch_equals_cpu_branch(launches, h, reverse):
    gx, whh, bhh, gout, h0 = _gru(h, seed=10 * h + 5)
    gates, w, b_ = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)

    def forward():
        with torch.no_grad():
            return tg.gru_scan_tm(gates, w, b_, reverse, torch.float32)

    def carry():
        return tg.gru_scan_carry_tm(gates, w, b_, torch.from_numpy(h0),
                                    reverse, torch.float32)

    def backward():
        h_seq = tg.gru_scan_reference_tm(gates, w, b_, reverse).to(
            torch.bfloat16)
        return tg.gru_scan_bwd_tm(gates, h_seq, _bf16(gout), w, b_, reverse)

    def grads():
        return _grads(lambda g, w_, bb: tg.gru_scan_tm(g, w_, bb, reverse),
                      gx, whh, bhh)

    for name, fn, kernels, exact in (
            ("forward", forward, dict(gru_scan_fwd=1), 1),
            ("carry", carry, dict(gru_scan_fwd_carry=1), 2),
            # dgates bit for bit; the contraction's fake sums the padded
            # width, so dW_hh and db_hh in another order
            ("backward", backward,
             dict(gru_scan_bwd=1, gru_scan_bwd_dwhh=1), 1),
            ("grads", grads, dict(gru_scan_fwd=1, gru_scan_bwd=1,
                                  gru_scan_bwd_dwhh=1), 1)):
        for k in launches:
            launches[k] = 0
        got = _as_tuple(fn())
        assert _counts(launches, **kernels), (name, launches)
        want = _as_tuple(_cpu(fn))
        for i, (a, b2) in enumerate(zip(got, want)):
            assert a.shape == b2.shape and a.dtype == b2.dtype, name
            if i < exact:
                assert torch.equal(a, b2), name
            else:
                torch.testing.assert_close(a, b2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_branch_matches_pallas_interpret(launches, h, reverse):
    gx, whh, gout, _, _ = _lstm(h, seed=10 * h + 1)
    want = np.asarray(jl.lstm_scan_tm(gx, whh, reverse, 576, True,
                                      jnp.float32))
    with torch.no_grad():
        got = tl.lstm_scan_tm(torch.from_numpy(gx), torch.from_numpy(whh),
                              reverse, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)

    gx_pad = jnp.asarray(_pad_rows(gx, LSTM_BLOCK), jnp.bfloat16)
    h_seq, c_seq = jl._lstm_pallas_call_train(gx_pad, whh, block_b=LSTM_BLOCK,
                                              interpret=True, reverse=reverse)
    got_h, got_c = tl.lstm_scan_train_tm(_bf16(gx), torch.from_numpy(whh),
                                         reverse)
    np.testing.assert_allclose(got_h.float().numpy(), _f32(h_seq)[:, :B],
                               **BF16)
    np.testing.assert_allclose(got_c.float().numpy(), _f32(c_seq)[:, :B],
                               **BF16)
    gout_pad = jnp.asarray(_pad_rows(gout, LSTM_BLOCK), jnp.bfloat16)
    want_dg = jl._lstm_pallas_call_bwd(gx_pad, h_seq, c_seq, gout_pad, whh,
                                       block_b=LSTM_BLOCK, interpret=True,
                                       reverse=reverse)
    got_dg = tl.lstm_scan_bwd_tm(_bf16(gx), _bf16(_f32(h_seq)[:, :B]),
                                 _bf16(_f32(c_seq)[:, :B]), _bf16(gout),
                                 torch.from_numpy(whh), reverse)
    np.testing.assert_allclose(got_dg.float().numpy(), _f32(want_dg)[:, :B],
                               **BF16)
    assert _counts(launches, lstm_scan_fwd=1, lstm_scan_fwd_train=1,
                   lstm_scan_bwd=1)


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_branch_matches_pallas_interpret(launches, h, reverse):
    gx, whh, bhh, gout, _ = _gru(h, seed=10 * h + 6)
    want = np.asarray(jl.gru_scan_tm(gx, whh, bhh, reverse, 256, True,
                                     jnp.float32))
    with torch.no_grad():
        got = tg.gru_scan_tm(*map(torch.from_numpy, (gx, whh, bhh)), reverse,
                             out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL)

    gx_pad = jnp.asarray(_pad_rows(gx, GRU_BLOCK), jnp.bfloat16)
    h_seq = jl._gru_pallas_call(gx_pad, whh, bhh, block_b=GRU_BLOCK,
                                interpret=True, out_dtype=jnp.bfloat16,
                                reverse=reverse)
    gout_pad = jnp.asarray(_pad_rows(gout, GRU_BLOCK), jnp.bfloat16)
    want_dgx, dw_blocks, db_blocks = jl._gru_pallas_call_bwd(
        gx_pad, h_seq, gout_pad, whh, bhh, block_b=GRU_BLOCK, interpret=True,
        reverse=reverse)
    got_dgx, got_dw, got_db = tg.gru_scan_bwd_tm(
        _bf16(gx), _bf16(_f32(h_seq)[:, :B]), _bf16(gout),
        torch.from_numpy(whh), torch.from_numpy(bhh), reverse)
    np.testing.assert_allclose(got_dgx.float().numpy(),
                               _f32(want_dgx)[:, :B], **BF16)
    np.testing.assert_allclose(got_dw.numpy(),
                               np.asarray(dw_blocks).sum(axis=0), **BF16)
    np.testing.assert_allclose(got_db.numpy(),
                               np.asarray(db_blocks).sum(axis=(0, 1)), **BF16)
    assert _counts(launches, gru_scan_fwd=1, gru_scan_bwd=1,
                   gru_scan_bwd_dwhh=1)


@pytest.mark.parametrize("h", HIDDEN)
def test_padded_units_stay_zero(h):
    """What the kernels compute at the padded width, with the plain
    versions: zero units stay zero through the forward, the training
    forward and both backward scans, and the real units keep their values."""
    hp = tl.scan_hidden(h)
    assert hp == tg.scan_hidden(h) and hp % 64 == 0 and hp - h < 64
    gx, whh, gout, h0, c0 = _lstm(h, seed=10 * h + 2)
    gates, w = _bf16(gx), torch.from_numpy(whh)
    pad_g, pad_w = tl._pad_gates(gates, 4, hp), tl._padded_weight(w, hp)
    out = tl.lstm_scan_reference_tm(pad_g, pad_w)
    assert not out[..., h:].any()
    torch.testing.assert_close(out[..., :h], tl.lstm_scan_reference_tm(
        gates, w), **BF16)
    seq, h_t, c_t = tl.lstm_scan_carry_reference_tm(
        pad_g, pad_w, tl._pad_units(torch.from_numpy(h0), hp),
        tl._pad_units(torch.from_numpy(c0), hp))
    assert not (seq[..., h:].any() or h_t[:, h:].any() or c_t[:, h:].any())
    h_seq, c_seq = tl.lstm_scan_train_reference_tm(pad_g, pad_w)
    assert not (h_seq[..., h:].any() or c_seq[..., h:].any())
    dg = tl.lstm_scan_bwd_reference_tm(pad_g, h_seq, c_seq,
                                       tl._pad_units(_bf16(gout), hp), pad_w)
    assert not dg.unflatten(-1, (4, hp))[..., h:].any()
    torch.testing.assert_close(
        tl._unpad_gates(dg, 4, h).float(),
        tl.lstm_scan_bwd_reference_tm(gates, h_seq[..., :h], c_seq[..., :h],
                                      _bf16(gout), w).float(), **BF16)

    gx, whh, bhh, gout, _ = _gru(h, seed=10 * h + 7)
    gates, w, b_ = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)
    pad_g, pad_w = tl._pad_gates(gates, 3, hp), tl._padded_weight(w, hp)
    pad_b = tl._pad_gates(b_, 3, hp)
    out = tg.gru_scan_reference_tm(pad_g, pad_w, pad_b)
    assert not out[..., h:].any()
    torch.testing.assert_close(out[..., :h], tg.gru_scan_reference_tm(
        gates, w, b_), atol=H_ATOL, rtol=0)
    h_seq = out.to(torch.bfloat16)
    dgx, dw, db = tg.gru_scan_bwd_reference_tm(
        pad_g, h_seq, tl._pad_units(_bf16(gout), hp), pad_w, pad_b)
    assert not dgx.unflatten(-1, (3, hp))[..., h:].any()
    assert not (dw[h:].any() or dw.unflatten(-1, (3, hp))[..., h:].any())
    assert not db.unflatten(-1, (3, hp))[..., h:].any()
    want = tg.gru_scan_bwd_reference_tm(gates, h_seq[..., :h],
                                        _bf16(gout), w, b_)
    for got, exp in zip((tl._unpad_gates(dgx, 3, h).float(),
                         tl._unpad_gates(dw[:h], 3, h),
                         tl._unpad_gates(db, 3, h)),
                        (want[0].float(), want[1], want[2])):
        torch.testing.assert_close(got, exp, **BF16)
