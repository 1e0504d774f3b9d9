"""The float32 compute mode of the port's recurrent layers against the JAX
package on the CPU.

A float32 JAX layer on the TPU (pallas_available()) makes bf16 gates from a
bf16 einsum with float32 accumulation plus the float32 bias, rounded once,
runs the Pallas scan on them with float32 output, and the rest of the model
in float32 (generative_audio_tpu/nn/recurrent.py LSTMLayer._scan,
GRULayer._scan). The port takes that "mixed" route for float32 tensors on
CUDA and the plain float32 loop on the CPU; `scan_kernels` runs the mixed
route on CPU tensors through the kernels' plain versions. Here it is held
against JAX's TPU route composed from the JAX package's own functions, the
Pallas kernels in interpret mode (forward, reverse, chunked; LSTM and GRU;
gradients through the custom VJPs by jax.grad).

Tolerances, the kernels' limits of PERF.md section 2 as fractions of the
peak |value|: h of the LSTM 5e-3 max / 3e-5 mean, of the GRU 5e-3 / 2e-4;
every gradient (dgates' limits) 5e-2 max / 2e-5 mean. Small models
(FullSubNet+, FullSubNet v1-GRU, DenoisingNPPCModel) on the mixed route
against the JAX float32 model: 5e-2 of the peak (the bf16-against-float32
limit of the card-against-CPU checks); the training loss 5e-3 relative,
gradient cosine 0.95, norm 15% (the bf16-against-float32 training limits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_audio_tpu.models import (
    FullSubNet as JaxFullSubNet, FullSubNetPlus as JaxFullSubNetPlus)
from generative_audio_tpu.models.nppc_model import (
    DenoisingNPPCConfig as JaxNPPCConfig, DenoisingNPPCModel as JaxNPPCModel,
    StftConfig as JaxStftConfig)
from generative_audio_tpu.models import (
    FullSubNetConfig as JaxFullSubNetConfig,
    FullSubNetPlusConfig as JaxPlusConfig, MultiDirectionConfig as JaxMDConfig)
from generative_audio_tpu.ops import pallas_lstm as jl
from generative_audio_torch.models import (
    DenoisingNPPCConfig, DenoisingNPPCModel, FullSubNet, FullSubNetConfig,
    FullSubNetPlus, FullSubNetPlusConfig, MultiDirectionConfig, StftConfig)
from generative_audio_torch.nn import recurrent as R
from generative_audio_torch.ops import lstm as tl
from generative_audio_torch.train import EnhanceTrainConfig, enhance_loss_fn
from generative_audio_torch.utils import convert

torch.set_num_threads(2)
BF16 = jnp.bfloat16
LSTM_H = (5e-3, 3e-5)
GRU_H = (5e-3, 2e-4)
GRADS = (5e-2, 2e-5)
PATH_REL = 5e-2
LOSS_REL, COSINE, NORM_REL = 5e-3, 0.95, 0.15
T_CHUNK = 4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _peak(got, want, limits, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() < limits[0] and err.mean() < limits[1], (
        what, err.max(), err.mean())


def _jax_lstm_route(x, w_ih, w_hh, bias, reverse, chunked):
    """JAX's TPU route of a float32 LSTMLayer: the hoisted bf16 gates, or
    the chunked layer with proj_dtype bf16, Pallas in interpret mode."""
    if chunked:
        return jl.lstm_layer_tm_chunked(x, w_ih, w_hh, bias, reverse, T_CHUNK,
                                        576, True, jnp.float32, BF16)
    gates = jnp.einsum("tbf,fg->tbg", x.astype(BF16), w_ih.astype(BF16),
                       preferred_element_type=jnp.float32) + bias
    return jl.lstm_scan_tm(gates.astype(BF16), w_hh, reverse, 576, True,
                           jnp.float32)


def _jax_gru_route(x, w_ih, w_hh, b_ih, b_hh, reverse, chunked):
    if chunked:
        return jl.gru_layer_tm_chunked(x, w_ih, w_hh, b_ih, b_hh, reverse,
                                       T_CHUNK, 576, True, jnp.float32, BF16)
    gates = jnp.einsum("tbf,fg->tbg", x.astype(BF16), w_ih.astype(BF16),
                       preferred_element_type=jnp.float32) + b_ih
    return jl.gru_scan_tm(gates.astype(BF16), w_hh, b_hh, reverse, 576, True,
                          jnp.float32)


def _weights(kind, f, h, seed):
    """JAX-layout weights [F, GH], [H, GH] and biases; G = 4 or 3."""
    g = (4 if kind == "LSTM" else 3) * h
    return (_rand((f, g), seed, 0.3), _rand((h, g), seed + 1, 0.3),
            _rand((g,), seed + 2, 0.5), _rand((g,), seed + 3, 0.5))


def _port_layer(kind, h):
    layer_cls = R.LSTMLayer if kind == "LSTM" else R.GRULayer
    return layer_cls(h, compute_dtype=torch.float32)


CASES = [("LSTM", False, False), ("LSTM", True, False), ("LSTM", False, True),
         ("LSTM", True, True), ("GRU", False, False), ("GRU", True, False),
         ("GRU", False, True), ("GRU", True, True)]


@pytest.mark.parametrize("kind,reverse,chunked", CASES,
                         ids=[f"{k}-{'rev' if r else 'fwd'}"
                              f"{'-chunked' if c else ''}"
                              for k, r, c in CASES])
def test_mixed_route_matches_jax_tpu_route(kind, reverse, chunked):
    """The mixed route's h and its gradients (x, W_ih, W_hh, b_ih, b_hh)
    against JAX's TPU route in interpret mode, jitted once per case."""
    t, b, f, h = 11, 6, 12, 16
    x = _rand((t, b, f), 1)
    gout = _rand((t, b, h), 2)
    w_ih, w_hh, b_ih, b_hh = _weights(kind, f, h, 3)

    if kind == "LSTM":
        def jfn(x, w_ih, w_hh, b_ih, b_hh):
            return _jax_lstm_route(x, w_ih, w_hh, b_ih + b_hh, reverse,
                                   chunked)
    else:
        def jfn(x, w_ih, w_hh, b_ih, b_hh):
            return _jax_gru_route(x, w_ih, w_hh, b_ih, b_hh, reverse,
                                  chunked)

    def jloss(*args):
        return jnp.sum(jfn(*args) * gout)

    args = (x, w_ih, w_hh, b_ih, b_hh)
    want_h = np.asarray(jax.jit(jfn)(*args))
    want_grads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*args)

    layer = _port_layer(kind, h)
    tens = [torch.from_numpy(a).requires_grad_() for a in args]
    tx, tw_ih, tw_hh, tb_ih, tb_hh = tens
    torch_w = (tw_ih.t(), tw_hh.t(), tb_ih, tb_hh)   # torch layout [GH, in]

    def run():
        if chunked:   # the route above the gates limit, in chunks of T_CHUNK
            return layer._scan_chunked(tx, *torch_w, reverse, T_CHUNK)
        return layer.scan_kernels(tx, *torch_w, reverse)

    with torch.no_grad():
        got = run()
        hoisted = layer.scan_kernels(tx, *torch_w, reverse)
    assert got.dtype == torch.float32
    _peak(got, want_h, LSTM_H if kind == "LSTM" else GRU_H, "h")
    # the same bf16 gates in chunks: bit for bit the hoisted route
    assert torch.equal(got, hoisted)
    # under grad the training forward's bf16 h comes out in float32, as the
    # JAX custom VJP's forward returns it
    trained = run()
    assert torch.equal(trained.detach(), got.to(torch.bfloat16).float())
    (trained * torch.from_numpy(gout)).sum().backward()
    for name, t_, want in zip(("dx", "dW_ih", "dW_hh", "db_ih", "db_hh"),
                              tens, want_grads):
        assert t_.grad is not None and t_.grad.dtype == torch.float32, name
        assert torch.isfinite(t_.grad).all(), name
        _peak(t_.grad, want, GRADS, name)


def test_mixed_gates_round_once():
    """mixed_gates = bf16(fp32 product + fp32 bias): where the bias is large
    it differs from the port's bf16 route, which rounds the bias and then the
    sum; its gradients arrive in the parameters' float32."""
    x = torch.from_numpy(_rand((7, 5, 12), 4))
    w = torch.from_numpy(_rand((12, 32), 5, 0.3)).requires_grad_()
    bias = torch.from_numpy(_rand((32,), 6, 40.0)).requires_grad_()
    got = tl.mixed_gates(x, w, bias)
    want = (x.to(torch.bfloat16).float() @ w.detach().to(torch.bfloat16).float()
            + bias.detach()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    twice = torch.nn.functional.linear(
        x.to(torch.bfloat16), w.detach().t().to(torch.bfloat16),
        bias.detach().to(torch.bfloat16))
    assert not torch.equal(twice, want)
    got.float().sum().backward()
    assert w.grad.dtype == torch.float32 and bias.grad.dtype == torch.float32
    torch.testing.assert_close(bias.grad, torch.full((32,), 35.0))


def test_float32_layers_take_the_kernels_on_cuda(monkeypatch):
    """The route's selection: float32 on CUDA is the mixed route (never the
    plain loop, never a refusal), float32 on the CPU the plain loop, bf16
    the kernels anywhere. With the selection stubbed to "mixed", a float32
    call on CPU tensors goes through scan_kernels, on both layers and both
    directions of a bidirectional layer."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for layer_cls in (R.LSTMLayer, R.GRULayer):
        layer = layer_cls(8, bidirectional=True, compute_dtype=torch.float32)
        assert layer.route(cuda) == "mixed"
        assert layer.route(cpu) == "float32"
        assert layer_cls(8, compute_dtype=torch.bfloat16).route(cuda) == "bf16"
        with pytest.raises(ValueError):
            layer_cls(8, compute_dtype=torch.float16).route(cuda)
        g = layer.num_gates * 8
        weights = [tuple(torch.from_numpy(_rand(s, seed + i, 0.3)) for i, s
                         in enumerate(((g, 6), (g, 8), (g,), (g,))))
                   for seed in (7, 17)]
        x = torch.from_numpy(_rand((5, 3, 6), 8))
        calls = []
        real = layer.scan_kernels

        def recording(*args, **kwargs):
            calls.append(args[-1])
            return real(*args, **kwargs)

        monkeypatch.setattr(layer, "route", lambda device: "mixed")
        monkeypatch.setattr(layer, "scan_kernels", recording)
        got = layer(x, weights[0], weights[1])
        assert calls == [False, True]
        want = torch.cat([real(x.transpose(0, 1), *weights[0], False),
                          real(x.transpose(0, 1), *weights[1], True)], -1)
        assert torch.equal(got, want.transpose(0, 1))
        monkeypatch.undo()
        plain = layer(x, weights[0], weights[1])
        assert not torch.equal(plain, got)


@pytest.fixture
def mixed_route(monkeypatch):
    """Every float32 layer takes the mixed route on the CPU, as on CUDA."""
    monkeypatch.setattr(
        R._RecurrentLayer, "route",
        lambda self, device: ("mixed" if self.compute_dtype == torch.float32
                              else "bf16"))


SMALL = dict(num_freqs=33, sb_num_neighbors=3, fb_model_hidden_size=32,
             sb_model_hidden_size=16)


def _inputs(batch, frames, seed):
    return (np.abs(_rand((batch, 1, 33, frames), seed)),
            _rand((batch, 1, 33, frames), seed + 1),
            _rand((batch, 1, 33, frames), seed + 2))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("model", ["fullsubnet_plus", "fullsubnet_gru"])
def test_mixed_models_match_jax_float32(mixed_route, model):
    """A small FullSubNet+ and v1-GRU on the mixed route (numpy-made
    weights in the JAX layout) against the JAX float32 model."""
    if model == "fullsubnet_plus":
        jcfg = JaxPlusConfig(num_groups_in_drop_band=1, **SMALL)
        params = convert.random_fullsubnet_plus_params(jcfg, seed=3)
        sd = convert.convert_fullsubnet_plus(params)
        port = FullSubNetPlus(FullSubNetPlusConfig(num_groups_in_drop_band=1,
                                                   **SMALL),
                              compute_dtype=torch.float32, device="cpu")
        jm, inputs = JaxFullSubNetPlus(jcfg), _inputs(2, 20, 11)
    else:
        kw = dict(num_freqs=33, sb_num_neighbors=3, fb_model_hidden_size=32,
                  sb_model_hidden_size=16, sequence_model="GRU",
                  num_groups_in_drop_band=1)
        jcfg = JaxFullSubNetConfig(**kw)
        params = convert.random_fullsubnet_params(jcfg, seed=4)
        sd = convert.convert_fullsubnet(params, "GRU")
        port = FullSubNet(FullSubNetConfig(**kw), compute_dtype=torch.float32,
                          device="cpu")
        jm, inputs = JaxFullSubNet(jcfg), _inputs(2, 20, 12)[:1]
    port.load_state_dict(sd)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *inputs))
    with torch.no_grad():
        got = port.eval()(*(torch.from_numpy(a) for a in inputs))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel = _rel(got.numpy(), want)
    # the mixed route is not the float32 loop: its bf16 gates and h move it
    assert 0 < rel < PATH_REL, rel


def test_mixed_denoising_nppc_matches_jax_float32(mixed_route):
    """DenoisingNPPCModel (enhancer and MultiDirection head) on the mixed
    route against the JAX float32 model: w_mat and the enhancer's cRM."""
    small = dict(num_freqs=32, sb_num_neighbors=2, fb_model_hidden_size=16,
                 sb_model_hidden_size=8)
    stft = dict(nfft=62, hop_length=32, win_length=62)
    jcfg = JaxNPPCConfig(
        restoration=JaxPlusConfig(num_groups_in_drop_band=1, **small),
        pc_wrapper=JaxMDConfig(n_directions=3, num_groups_in_drop_band=2,
                               **small),
        stft=JaxStftConfig(**stft))
    cfg = DenoisingNPPCConfig(
        restoration=FullSubNetPlusConfig(num_groups_in_drop_band=1, **small),
        pc_wrapper=MultiDirectionConfig(n_directions=3,
                                        num_groups_in_drop_band=2, **small),
        stft=StftConfig(**stft))
    params = convert.random_denoising_nppc_params(cfg, seed=0)
    model = DenoisingNPPCModel(cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.convert_denoising_nppc(params))
    noisy = _rand((4, 2048), 13, 0.3)
    want_w, want_crm = jax.jit(lambda p, x: JaxNPPCModel(jcfg).apply(
        {"params": p}, x, method=JaxNPPCModel.forward_with_pred_crm))(
        params, noisy)
    with torch.no_grad():
        got_w, got_crm = model.forward_with_pred_crm(torch.from_numpy(noisy))
    for what, got, want in (("w_mat", got_w, want_w),
                            ("pred_crm", got_crm, want_crm)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all(), what
        rel = _rel(got.numpy(), want)
        assert 0 < rel < PATH_REL, (what, rel)


def test_mixed_training_gradient_matches_float32(mixed_route):
    """One FullSubNet+ training loss (drop_band G=2) on the mixed route
    against the same model on the float32 route: every parameter gets a
    float32 gradient, and the loss, the gradient's cosine and its norm stay
    within the bf16-against-float32 training limits."""
    cfg = EnhanceTrainConfig(
        model=FullSubNetPlusConfig(num_groups_in_drop_band=2, **SMALL),
        n_fft=64, hop_length=32, win_length=64, compute_dtype="float32")
    sd = convert.convert_fullsubnet_plus(convert.random_fullsubnet_plus_params(
        JaxPlusConfig(num_groups_in_drop_band=2, **SMALL), seed=5))
    clean = torch.from_numpy(_rand((4, 4000), 14, 0.1))
    noisy = clean + torch.from_numpy(_rand((4, 4000), 15, 0.03))
    results = {}
    for route in ("mixed", "float32"):
        model = FullSubNetPlus(cfg.model, compute_dtype=torch.float32,
                               device="cpu")
        model.load_state_dict(sd)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(R._RecurrentLayer, "route",
                       lambda self, device, r=route: r)
            loss = enhance_loss_fn(model, noisy, clean, cfg)
            loss.backward()
        grads = []
        for name, p in model.named_parameters():
            assert p.grad is not None, (route, name)
            assert p.grad.dtype == torch.float32, (route, name)
            assert torch.isfinite(p.grad).all(), (route, name)
            grads.append(p.grad.flatten())
        results[route] = (loss.item(), torch.cat(grads))
    (loss_m, g_m), (loss_f, g_f) = results["mixed"], results["float32"]
    assert abs(loss_m - loss_f) / abs(loss_f) < LOSS_REL
    assert torch.nn.functional.cosine_similarity(g_m, g_f, 0) > COSINE
    assert abs(g_m.norm() / g_f.norm() - 1) < NORM_REL
    assert not torch.equal(g_m, g_f)
