"""generative_audio_torch.ops.gru on the CPU: the plain versions of the three
CUDA GRU kernels, and the autograd Function around them, against the JAX
package's Pallas kernels run in interpret mode (as tests/test_pallas_lstm.py
runs them).

Both sides compute the same bf16 algorithm: bf16 x-side gates, fp32 h on
chip that is cast to bf16 only as the operand of the product with bf16 W_hh,
fp32 accumulation and fp32 b_hh; in the backward bf16 h_seq, gout and dgates
streams and fp32 dh, dW_hh and db_hh. They differ in the order of the sums
and in the transcendental functions, and a float32 difference that crosses
a bf16 rounding boundary moves that value by one bf16 step (2^-8 relative).
So: atol 5e-3 on h (in (-1, 1)), as tests/test_pallas_lstm.py::TestPallasGRU
has it; 1e-2 absolute plus 1e-2 relative on dgates, dW_hh and db_hh against
the Pallas backward on the same residuals; gradients against the exact
float32 recurrence get the JAX tests' atol 2e-2 / rtol 1e-2. The chunked and
unchunked scans of the same gates must agree bit for bit.

torch.autograd.gradcheck is not applicable to GRUScan: the bf16 roundings
make the function piecewise constant at gradcheck's step sizes. The
exact-gradient comparison takes its place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import gru as tg
from generative_audio_torch.ops import lstm as tl
from test_torch_lstm_backward import (BACKWARD_UNITS, FORWARD_UNITS, fill,
                                      real_units, real_weight, strip,
                                      stub_stream_plans, unstream)

torch.set_num_threads(2)
H_ATOL = 5e-3
BF16 = dict(atol=1e-2, rtol=1e-2)
EXACT = dict(atol=2e-2, rtol=1e-2)
BLOCK = 8       # the Pallas calls take a batch padded to their block


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pad(x, b_pad):
    return np.pad(x, ((0, 0), (0, b_pad - x.shape[1]), (0, 0)))


def _operands(t, b, h, seed):
    return (_rand((t, b, 3 * h), seed), _rand((h, 3 * h), seed + 1, 0.2),
            _rand((3 * h,), seed + 2, 0.1))


# the TestPallasGRU shapes, and TestPallasBackwardKernel's padded batch 11
CASES = [(13, 12, 16, False), (7, 8, 8, True), (6, 11, 8, False),
         (6, 11, 8, True)]


@pytest.mark.parametrize("t,b,h,reverse", CASES)
def test_scan_matches_pallas_interpret(t, b, h, reverse):
    gx, whh, bhh = _operands(t, b, h, seed=10)
    want = np.asarray(jl.gru_scan_tm(gx, whh, bhh, reverse, 256, True,
                                     jnp.float32))
    tgx, twhh, tbhh = map(torch.from_numpy, (gx, whh, bhh))
    got = tg.gru_scan_tm(tgx, twhh, tbhh, reverse, out_dtype=torch.float32)
    assert tuple(got.shape) == (t, b, h)
    np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL)
    # the plain version is the wrapper's CPU path, bit for bit, and the bf16
    # output is the float32 output rounded once
    plain = tg.gru_scan_reference_tm(tgx.to(torch.bfloat16), twhh, tbhh,
                                     reverse)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    out16 = tg.gru_scan_tm(tgx, twhh, tbhh, reverse)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, got.to(torch.bfloat16))
    # and the float32 recurrence is the JAX lax.scan reference
    exact = tg.gru_scan_reference_tm(tgx, twhh, tbhh, reverse,
                                     compute_dtype=torch.float32)
    ref = np.asarray(jl.gru_scan_reference_tm(gx, whh, bhh, reverse,
                                              compute_dtype=jnp.float32))
    np.testing.assert_allclose(exact.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_carry_chunks_equal_unchunked_bitwise(reverse):
    """The carry kernel's plain version over chunks of the same bf16 gates
    equals the forward kernel's, bit for bit (ragged, whole and oversize
    chunks)."""
    t, b, h = 37, 12, 16
    gx, whh, bhh = _operands(t, b, h, seed=20)
    gates, whh, bhh = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)
    want = tg.gru_scan_tm(gates, whh, bhh, reverse, torch.float32)
    for t_chunk in (8, 16, 37, 64):
        hs = torch.zeros(b, h)
        out = torch.empty(t, b, h)
        starts = list(range(0, t, t_chunk))
        for s in (starts[::-1] if reverse else starts):
            e = min(s + t_chunk, t)
            out[s:e], hs = tg.gru_scan_carry_tm(gates[s:e], whh, bhh, hs,
                                                reverse, torch.float32)
        np.testing.assert_array_equal(out.numpy(), want.numpy(),
                                      err_msg=f"{t_chunk=}")


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_layer_matches_pallas_interpret(reverse):
    """gru_layer_tm_chunked against the JAX function of the same name (the
    TestChunkedGRULayer set-up), bit-identical to the unchunked hoisted
    projection + scan."""
    t, b, f, h = 37, 12, 20, 16
    x = _rand((t, b, f), seed=30, scale=0.3)
    wi = _rand((f, 3 * h), seed=31, scale=0.2)
    wh = _rand((h, 3 * h), seed=32, scale=0.2)
    bi = _rand((3 * h,), seed=33, scale=0.1)
    bh = _rand((3 * h,), seed=34, scale=0.1)
    tx, twi, twh, tbi, tbh = map(torch.from_numpy, (x, wi, wh, bi, bh))
    unchunked = tg.gru_scan_tm(tx @ twi + tbi, twh, tbh, reverse,
                               torch.float32)
    for t_chunk in (8, 37):
        want = np.asarray(jl.gru_layer_tm_chunked(
            x, wi, wh, bi, bh, reverse, t_chunk, 576, True, jnp.float32))
        got = tg.gru_layer_tm_chunked(tx, twi, twh, tbi, tbh, reverse,
                                      t_chunk, out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=H_ATOL)
        np.testing.assert_array_equal(got.numpy(), unchunked.numpy())


def _pallas_h_seq(gx, whh, bhh, reverse):
    """(padded bf16 gates, bf16 h_seq) from the Pallas forward, as _gru_fwd
    saves them."""
    b_pad = -(-gx.shape[1] // BLOCK) * BLOCK
    gx_pad = jnp.asarray(_pad(gx, b_pad), jnp.bfloat16)
    h_seq = jl._gru_pallas_call(gx_pad, whh, bhh, block_b=BLOCK,
                                interpret=True, out_dtype=jnp.bfloat16,
                                reverse=reverse)
    return gx_pad, h_seq


@pytest.mark.parametrize("t,b,h,reverse", CASES)
def test_backward_matches_pallas_interpret(t, b, h, reverse):
    """The plain backward against the Pallas backward kernel on the SAME
    residuals and cotangent; the Pallas block partials of dW_hh and db_hh
    are summed as its caller sums them."""
    gx, whh, bhh = _operands(t, b, h, seed=40)
    gx_pad, h_seq = _pallas_h_seq(gx, whh, bhh, reverse)
    gout = _rand((t, b, h), seed=45)
    gout_pad = jnp.asarray(_pad(gout, gx_pad.shape[1]), jnp.bfloat16)
    want_dgx, dw_blocks, db_blocks = jl._gru_pallas_call_bwd(
        gx_pad, h_seq, gout_pad, whh, bhh, block_b=BLOCK, interpret=True,
        reverse=reverse)
    assert dw_blocks.shape[0] == gx_pad.shape[1] // BLOCK
    got_dgx, got_dw, got_db = tg.gru_scan_bwd_tm(
        _bf16(gx), _bf16(_f32(h_seq)[:, :b]), _bf16(gout),
        torch.from_numpy(whh), torch.from_numpy(bhh), reverse)
    assert got_dgx.dtype == torch.bfloat16
    assert got_dw.dtype == got_db.dtype == torch.float32
    assert tuple(got_dgx.shape) == (t, b, 3 * h)
    np.testing.assert_allclose(got_dgx.float().numpy(),
                               _f32(want_dgx)[:, :b], **BF16)
    np.testing.assert_allclose(got_dw.numpy(),
                               np.asarray(dw_blocks).sum(axis=0), **BF16)
    np.testing.assert_allclose(got_db.numpy(),
                               np.asarray(db_blocks).sum(axis=(0, 1)), **BF16)
    # padded rows (zero gates, zero cotangent) give exactly zero dgates, so
    # a masked ragged tile and a padded one agree
    assert not np.any(_f32(want_dgx)[:, b:])


def _torch_grads(fn, gx, whh, bhh, reverse, ct):
    ts = [torch.from_numpy(a).requires_grad_() for a in (gx, whh, bhh)]
    y = fn(*ts, reverse)
    loss = (y * torch.from_numpy(ct)).sum() if ct is not None else (y ** 2).sum()
    loss.backward()
    return [a.grad.numpy() for a in ts]


GRAD_CASES = {      # shape, seed, reverse, whether a random cotangent
    "forward": ((7, 8, 8), 13, False, False),
    "reverse_batch11": ((6, 11, 8), 31, True, False),
    "cotangent": ((6, 8, 16), 50, False, True),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gru_scan_gradients_match_jax(case):
    """GRUScan (the plain kernels on the CPU) against jax.grad through the
    Pallas forward and backward kernels in interpret mode, and against the
    exact gradient of the float32 recurrence."""
    (t, b, h), seed, reverse, with_ct = GRAD_CASES[case]
    gx, whh, bhh = _operands(t, b, h, seed)
    ct = _rand((t, b, h), seed + 5) if with_ct else None

    def jax_loss(g_, w_, b_):
        y = jl.gru_scan_tm(g_, w_, b_, reverse, 256, True, jnp.float32)
        return jnp.sum(y * ct) if ct is not None else jnp.sum(y ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(gx, whh, bhh)
    got = _torch_grads(
        lambda g, w, b_, r: tg.gru_scan_tm(g, w, b_, r, torch.float32),
        gx, whh, bhh, reverse, ct)
    exact = _torch_grads(
        lambda g, w, b_, r: tg.gru_scan_reference_tm(
            g, w, b_, r, compute_dtype=torch.float32), gx, whh, bhh, reverse,
        ct)
    for a, w_, e in zip(got, want, exact):
        assert a.dtype == np.float32 and a.shape == e.shape
        np.testing.assert_allclose(a, np.asarray(w_), **EXACT)
        np.testing.assert_allclose(a, e, **EXACT)


def test_chunked_layer_gradients_match_unchunked():
    """Under grad the chunked layer takes the full projection + GRUScan, so
    its gradients equal the unchunked layer's exactly."""
    t, b, f, h = 11, 5, 6, 8
    arrays = (_rand((t, b, f), 60), _rand((f, 3 * h), 61, 0.3),
              _rand((h, 3 * h), 62, 0.2), _rand((3 * h,), 63, 0.1),
              _rand((3 * h,), 64, 0.1))

    def grads(chunked):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        tx, twi, twh, tbi, tbh = ts
        if chunked:
            y = tg.gru_layer_tm_chunked(tx, twi, twh, tbi, tbh, False, 4,
                                        torch.float32)
        else:
            y = tg.gru_scan_tm(tx @ twi + tbi, twh, tbh, False, torch.float32)
        (y ** 2).sum().backward()
        return [a.grad for a in ts]

    for a, b_ in zip(grads(True), grads(False)):
        assert a is not None and torch.equal(a, b_)


def fake_launch(fn_name, *args, plan=None):
    """Stands in for the launch helper where there is no card: runs what
    each GRU kernel computes into the output buffers it was given, with the
    kernel's partials (db_hh per 16-row block, dW_hh per slice of rows), and
    counts the launch as the helper does. The scans check the zero padding
    of H the wrapper handed the kernel and compute on the real units, as
    tests/test_torch_lstm_backward.py's fake does; the contraction, whose
    padded rows and columns come out zero, computes on what it is given. The
    single-block forwards ("_block") take the cluster entries' arguments at
    H padded to whole k-steps, the streamed ones ("_stream", forwards and
    the backward scan) and the wide backward scan ("_wide") with W_hh
    packed for their plan. The contraction cuts the rows as its plan says:
    slices of the full tiles, narrow tiles' own count, the partials beyond
    it zero in the narrow tiles' columns."""
    tl.launch_counts[fn_name] += 1
    units, bwd_units = FORWARD_UNITS, BACKWARD_UNITS
    if fn_name.endswith("_block"):
        fn_name, units = fn_name[:-len("_block")], BACKWARD_UNITS
    elif fn_name.endswith(("_stream", "_wide")):
        fn_name, args, units = unstream(fn_name, args, plan, 3)
        bwd_units = units
    if fn_name == "gru_scan_fwd":
        gates, wt, bhh, out, _, _, _, _, reverse = args
        h = real_units(wt, 3, units)
        fill(out, tg.gru_scan_reference_tm(strip(gates, h, 3),
                                           real_weight(wt, h, 3),
                                           strip(bhh, h, 3), bool(reverse)))
    elif fn_name == "gru_scan_fwd_carry":
        gates, wt, bhh, h0, out, h_t, _, _, _, _, reverse = args
        h = real_units(wt, 3, units)
        seq, hn = tg.gru_scan_carry_reference_tm(
            strip(gates, h, 3), real_weight(wt, h, 3), strip(bhh, h, 3),
            strip(h0, h), bool(reverse), out.dtype)
        fill(out, seq), fill(h_t, hn)
    elif fn_name == "gru_scan_bwd":
        (gates, h_seq, gout, wt, w, wf, bhh, dgx, dhn, db_blocks, n_blocks, _,
         b, _, reverse) = args
        assert torch.equal(wt.t(), w) and bhh.dtype == torch.float32
        assert torch.equal(wf, tl._fragment_weight(wt))
        assert db_blocks.shape[0] == n_blocks == -(-b // 16)
        h = real_units(wt, 3, bwd_units)
        gates, h_seq, gout = strip(gates, h, 3), strip(h_seq, h), strip(gout, h)
        w, bhh = real_weight(wt, h, 3), strip(bhh, h, 3)
        for i in range(db_blocks.shape[0]):
            rows = slice(16 * i, 16 * (i + 1))
            dg, dn, db = tg.gru_scan_bwd_streams_reference_tm(
                gates[:, rows], h_seq[:, rows], gout[:, rows], w, bhh,
                bool(reverse))
            fill(dgx[:, rows], dg, 3), fill(dhn[:, rows], dn)
            fill(db_blocks[i], db, 3)
    elif fn_name == "gru_scan_bwd_dwhh":
        h_prev, dgx, dhn, part, n, hsz = args
        assert h_prev.shape[0] == dgx.shape[0] == dhn.shape[0] == n
        assert h_prev.shape[1] == hsz and hsz % BACKWARD_UNITS == 0
        assert part.shape[0] == plan.slices
        full = tg.gru_dwhh_reference(h_prev, dgx, dhn)
        narrow = torch.zeros_like(full, dtype=torch.bool)
        for c0, c1 in ((0, 2 * hsz), (2 * hsz, 3 * hsz)):   # ragged columns
            for c in range(c0, c1, 256):
                narrow[:, c:min(c + 256, c1)] = c1 - c < 256
        for i in range(plan.slices):
            rows = slice(plan.rows_per_slice * i, plan.rows_per_slice * (i + 1))
            got = tg.gru_dwhh_reference(h_prev[rows], dgx[rows], dhn[rows])
            rows = slice(plan.narrow_rows * i, plan.narrow_rows * (i + 1))
            got_n = (tg.gru_dwhh_reference(h_prev[rows], dgx[rows], dhn[rows])
                     if i < plan.narrow_slices else torch.zeros_like(full))
            part[i] = torch.where(narrow, got_n, got)
    else:
        raise KeyError(fn_name)


GRU_KERNELS = ("gru_scan_fwd", "gru_scan_fwd_carry", "gru_scan_bwd",
               "gru_scan_bwd_dwhh")


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors, with fake_launch and
    the streamed forwards' plans from a stub occupancy."""
    monkeypatch.setattr(tg, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tg, "_launch", fake_launch)
    monkeypatch.setattr(tl, "launch_counts", dict.fromkeys(tl.launch_counts, 0))
    stub_stream_plans(monkeypatch)
    return tl.launch_counts


def test_launch_counts_are_shared_with_the_lstm():
    """One dict for every kernel of the port, GRU entries included."""
    assert set(GRU_KERNELS) < set(tl.launch_counts)
    assert {"lstm_scan_fwd", "lstm_scan_bwd"} < set(tl.launch_counts)
    assert {tl._SOURCE_OF[k] for k in GRU_KERNELS} == {"gru_scan",
                                                       "gru_scan_bwd"}


def test_grad_inputs_get_a_grad_fn():
    gx, whh, bhh = (torch.from_numpy(a).requires_grad_()
                    for a in _operands(4, 3, 16, seed=70))
    for out_dtype in (torch.bfloat16, torch.float32):
        y = tg.gru_scan_tm(gx, whh, bhh, out_dtype=out_dtype)
        assert y.grad_fn is not None and y.dtype == out_dtype
    with torch.no_grad():
        assert tg.gru_scan_tm(gx, whh, bhh).grad_fn is None


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_route_by_grad_mode(launches, reverse):
    """On the kernels' branch: grad -> one forward launch and, in backward,
    one backward scan and one dW_hh contraction; no_grad -> the forward
    kernel only; a chunked layer -> the carry kernel only. The results equal
    the CPU branch's, so the wrappers pass the kernels the right operands in
    the right order, both weight layouts, and sum the partials (19 rows are
    two 16-row blocks; 6 x 19 shifted rows are 16 ragged slices)."""
    gx, whh, bhh = _operands(7, 19, 16, seed=80)

    def route(g, w, b_, r):
        return tg.gru_scan_tm(g, w, b_, r)

    got = _torch_grads(route, gx, whh, bhh, reverse, None)
    expect = dict.fromkeys(launches, 0)
    expect.update(gru_scan_fwd=1, gru_scan_bwd=1, gru_scan_bwd_dwhh=1)
    assert launches == expect
    tgx, twhh, tbhh = map(torch.from_numpy, (gx, whh, bhh))
    with torch.no_grad():
        infer = tg.gru_scan_tm(tgx, twhh, tbhh, reverse)
        assert launches["gru_scan_fwd"] == 2 and launches["gru_scan_bwd"] == 1
        x = torch.from_numpy(_rand((7, 19, 5), seed=83))
        wi = torch.from_numpy(_rand((5, 48), seed=84, scale=0.3))
        chunked = tg.gru_layer_tm_chunked(x, wi, twhh, tbhh, tbhh, reverse, 3)
        assert launches["gru_scan_fwd_carry"] == 3
        assert launches["gru_scan_fwd"] == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "_is_cuda", lambda *tensors: False)
        want = _torch_grads(route, gx, whh, bhh, reverse, None)
        with torch.no_grad():
            assert torch.equal(infer, tg.gru_scan_tm(tgx, twhh, tbhh, reverse))
            assert torch.equal(chunked, tg.gru_layer_tm_chunked(
                x, wi, twhh, tbhh, tbhh, reverse, 3))
    np.testing.assert_array_equal(got[0], want[0])          # dgates
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)  # dW_hh
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)  # db_hh
    assert launches == {**expect, "gru_scan_fwd": 2, "gru_scan_fwd_carry": 3}


def test_single_step_has_no_dwhh(launches):
    """T = 1: the only step saw h = 0, so dW_hh is zero and the contraction
    is not launched."""
    gx, whh, bhh = _operands(1, 5, 16, seed=90)
    grads = _torch_grads(lambda g, w, b_, r: tg.gru_scan_tm(g, w, b_, r),
                         gx, whh, bhh, False, None)
    assert launches["gru_scan_bwd"] == 1
    assert launches["gru_scan_bwd_dwhh"] == 0
    assert not grads[1].any() and grads[2].any()


def test_kernel_operands_are_checked(launches):
    gx, whh, bhh = _operands(3, 2, 16, seed=95)
    gates, whh, bhh = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)
    seq = torch.zeros(3, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):                     # fp32 residual
        tg.gru_scan_bwd_tm(gates, seq.float(), seq, whh, bhh)
    with pytest.raises(TypeError):                     # fp32 gates
        tg.gru_scan_bwd_tm(gates.float(), seq, seq, whh, bhh)
    with pytest.raises(ValueError):                    # shape of gout
        tg.gru_scan_bwd_tm(gates, seq, seq[:2], whh, bhh)
    with pytest.raises(ValueError):                    # not contiguous
        tg.gru_scan_tm(gates.transpose(0, 1).contiguous().transpose(0, 1),
                       whh, bhh)
    with pytest.raises(TypeError):                     # bf16 state
        tg.gru_scan_carry_tm(gates, whh, bhh,
                             torch.zeros(2, 16, dtype=torch.bfloat16))
    assert not any(launches.values())
    # no cluster of 16 holds the W_hh slice of H = 1024 in shared memory, so
    # the forward takes the streamed cluster (part of the slice from L2 at
    # every step), as the JAX kernels take any H
    gx, whh, bhh = _operands(2, 1, 1024, seed=96)
    big, whh, bhh = _bf16(gx), torch.from_numpy(whh), torch.from_numpy(bhh)
    got = tg.gru_scan_tm(big, whh, bhh)
    assert launches == {**dict.fromkeys(launches, 0), "gru_scan_fwd_stream": 1}
    assert torch.equal(got, tg.gru_scan_reference_tm(big, whh, bhh).to(
        torch.bfloat16))


def test_dispatch_by_device_without_fallback():
    """CPU tensors take the plain version and count no launch; a device that
    is neither CPU nor CUDA, a mix of devices or a wrong shape raises."""
    gx, whh, bhh = (torch.from_numpy(a) for a in _operands(3, 2, 16, seed=97))
    before = dict(tl.launch_counts)
    tg.gru_scan_tm(gx, whh, bhh)
    tg.gru_scan_carry_tm(gx, whh, bhh, torch.zeros(2, 16))
    assert tl.launch_counts == before
    with pytest.raises(ValueError):
        tg.gru_scan_tm(gx.to("meta"), whh.to("meta"), bhh.to("meta"))
    with pytest.raises(ValueError):
        tg.gru_scan_tm(gx, whh.to("meta"), bhh)
    with pytest.raises(ValueError):
        tg.gru_scan_tm(gx, whh[:8], bhh)
    with pytest.raises(ValueError):
        tg.gru_scan_tm(gx, whh, bhh[:5])
    with pytest.raises(ValueError):
        tg.gru_scan_carry_tm(gx, whh, bhh, torch.zeros(3, 16))


def test_sources_match_their_declared_signatures():
    """Without a compiler: every entry of every source takes as many
    arguments as ops/_cuda.py declares for it (the stream is the last), and
    every header a source includes lies beside it."""
    import re

    from generative_audio_torch.ops import _cuda
    for source, entries in _cuda._SIGNATURES.items():
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        for header in re.findall(r'#include "([^"]+)"', text):
            assert (_cuda.CSRC / header).is_file(), (source, header)
        for entry, argtypes in entries.items():
            params = re.search(rf"\bint {entry}\(([^)]*)\)", text).group(1)
            assert len(params.split(",")) == len(argtypes), entry
            assert params.split(",")[-1].strip() == "void* stream", entry


def test_build_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library's cached name changes when its source or a header changes."""
    from generative_audio_torch.ops import _cuda
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int ROWS = 16;\n")
    first = _cuda._lib_path("k")
    assert _cuda._lib_path("k") == first
    (tmp_path / "common.cuh").write_text("constexpr int ROWS = 32;\n")
    second = _cuda._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert len({first, second, _cuda._lib_path("k")}) == 3
