"""generative_audio_torch.ops.lstm on the CPU: the plain versions of the two
CUDA scan kernels against the JAX package's Pallas kernels run in interpret
mode, as tests/test_pallas_lstm.py runs them.

Both sides use bf16 gates, bf16 h and W_hh into the product with float32
accumulation, and float32 c. They differ only in the order of the sums and
in the transcendental functions, and a float32 difference that moves h
across a bf16 rounding boundary changes that h by one bf16 step (2^-8
relative) for the next product. So the tolerance is a bf16 one: 1e-2
absolute on h, which lies in (-1, 1). The chunked and unchunked scans of the
same gates must agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.ops import lstm as tl

torch.set_num_threads(2)
BF16_ATOL = 1e-2


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("t,b,h,reverse", [
    (13, 12, 16, False),     # forward
    (9, 8, 16, True),        # reverse
    (5, 11, 32, False),      # ragged batch: not a multiple of any block
])
def test_scan_matches_pallas_interpret(t, b, h, reverse):
    gx = _rand((t, b, 4 * h), seed=1)
    whh = _rand((h, 4 * h), seed=2, scale=0.2)
    want = np.asarray(jl.lstm_scan_tm(gx, whh, reverse, 576, True,
                                      jnp.float32))
    got = tl.lstm_scan_tm(torch.from_numpy(gx), torch.from_numpy(whh),
                          reverse, out_dtype=torch.float32)
    assert tuple(got.shape) == (t, b, h)
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)
    # the plain version is the wrapper's CPU path, bit for bit
    plain = tl.lstm_scan_reference_tm(
        torch.from_numpy(gx).to(torch.bfloat16), torch.from_numpy(whh), reverse)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_reverse_differs_from_forward():
    gx = torch.from_numpy(_rand((9, 4, 64), seed=3))
    whh = torch.from_numpy(_rand((16, 64), seed=4, scale=0.2))
    fwd = tl.lstm_scan_tm(gx, whh, False, torch.float32)
    rev = tl.lstm_scan_tm(gx, whh, True, torch.float32)
    assert (fwd - rev).abs().max() > 1e-3


def test_bf16_output_is_rounded_float32_output():
    gx = torch.from_numpy(_rand((6, 5, 64), seed=5))
    whh = torch.from_numpy(_rand((16, 64), seed=6, scale=0.2))
    out32 = tl.lstm_scan_tm(gx, whh, out_dtype=torch.float32)
    out16 = tl.lstm_scan_tm(gx, whh, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16, out32.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_carry_chunks_equal_unchunked_bitwise(reverse):
    """Kernel B's plain version over chunks of the same bf16 gates equals
    kernel A's, bit for bit (ragged, whole and oversize chunks)."""
    t, b, h = 37, 12, 16
    gates = torch.from_numpy(_rand((t, b, 4 * h), seed=7)).to(torch.bfloat16)
    whh = torch.from_numpy(_rand((h, 4 * h), seed=8, scale=0.2))
    want = tl.lstm_scan_tm(gates, whh, reverse, torch.float32)
    for t_chunk in (8, 16, 37, 64):
        hs = torch.zeros(b, h)
        cs = torch.zeros(b, h)
        out = torch.empty(t, b, h)
        starts = list(range(0, t, t_chunk))
        for s in (starts[::-1] if reverse else starts):
            e = min(s + t_chunk, t)
            out[s:e], hs, cs = tl.lstm_scan_carry_tm(gates[s:e], whh, hs, cs,
                                                     reverse, torch.float32)
        np.testing.assert_array_equal(out.numpy(), want.numpy(),
                                      err_msg=f"{t_chunk=}")


@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_layer_matches_pallas_interpret(reverse):
    """lstm_layer_tm_chunked against the JAX function of the same name, and
    against the unchunked hoisted projection + scan."""
    t, b, f, h = 37, 12, 20, 16
    x = _rand((t, b, f), seed=10, scale=0.3)
    wi = _rand((f, 4 * h), seed=11, scale=0.2)
    wh = _rand((h, 4 * h), seed=12, scale=0.2)
    bias = _rand((4 * h,), seed=13, scale=0.1)
    tx, twi, twh, tb = map(torch.from_numpy, (x, wi, wh, bias))
    unchunked = tl.lstm_scan_tm(tx @ twi + tb, twh, reverse, torch.float32)
    for t_chunk in (8, 37):
        want = np.asarray(jl.lstm_layer_tm_chunked(
            x, wi, wh, bias, reverse, t_chunk, 576, True, jnp.float32))
        got = tl.lstm_layer_tm_chunked(tx, twi, twh, tb, reverse, t_chunk,
                                       out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)
        np.testing.assert_allclose(got.numpy(), unchunked.numpy(),
                                   atol=BF16_ATOL)


def test_dispatch_by_device_without_fallback():
    """CPU tensors take the plain version and count no launch; a device that
    is neither CPU nor CUDA, or a mix of devices, raises."""
    gx = torch.from_numpy(_rand((3, 2, 64), seed=14))
    whh = torch.from_numpy(_rand((16, 64), seed=15, scale=0.2))
    before = dict(tl.launch_counts)
    tl.lstm_scan_tm(gx, whh)
    tl.lstm_scan_carry_tm(gx, whh, torch.zeros(2, 16), torch.zeros(2, 16))
    assert tl.launch_counts == before
    with pytest.raises(ValueError):
        tl.lstm_scan_tm(gx.to("meta"), whh.to("meta"))
    with pytest.raises(ValueError):
        tl.lstm_scan_tm(gx, whh.to("meta"))
    with pytest.raises(ValueError):
        tl.lstm_scan_tm(gx, whh[:8])
