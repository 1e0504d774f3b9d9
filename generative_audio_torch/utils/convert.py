"""Carry the JAX package's FullSubNet+ (every attention kind and sub-band
fold), FullSubNet, denoising-NPPC, inpainting (UNet), image-net (ImageUNet,
ResUNet, ResCNN), ComplexSequenceModel, causal conv block and MOSNet params
into the port's state_dict, and back.

The input is the nested dict of arrays that `model.init(...)["params"]` of
generative_audio_tpu's FullSubNetPlus or FullSubNet gives (numpy or anything
`np.asarray` takes). The output uses the reference checkpoint's key names,
e.g. `sb_model.sequence_model.weight_ih_l0` and
`fb_model.sequence_model.3.depthwise_conv.weight`, so it loads into the
port's FullSubNetPlus with `load_state_dict` and is the exact inverse of
generative_audio_tpu/utils/torch_convert.py:80-176 (convert_fullsubnet_plus,
convert_fullsubnet).

`to_jax_fullsubnet_plus` and `to_jax_fullsubnet` are the inverse: a `state_dict`, or a dict of
gradients under state-dict names, becomes numpy arrays in the JAX param
layout, so that a test can lay the port's gradients and updated parameters
beside the JAX tree.

Layout transforms (JAX -> torch):
  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel [k, in/g, out]      -> Conv1d weight [out, in/g, k]
  1x1 conv as Dense [in, out]     -> Conv1d weight [out, in, 1]
  LSTM w_ih [in, 4H], w_hh [H, 4H] -> weight_ih_l{n} [4H, in], weight_hh_l{n} [4H, H]
  GRU  w_ih [in, 3H], w_hh [H, 3H] -> weight_ih_l{n} [3H, in], weight_hh_l{n} [3H, H]
  Conv2d kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  ConvTranspose kernel [kh, kw, in, out] (flax: not flipped)
                                   -> ConvTranspose2d weight [in, out, kh, kw],
                                      both spatial axes flipped
  BatchNorm scale, bias            -> weight, bias; batch_stats mean, var
                                      -> running_mean, running_var

The UNets' variables are flax's {"params": ..., "batch_stats": ...}; their
state-dict names are the reference's (generative_audio_tpu/utils/
torch_convert.py:182-221), `num_batches_tracked` set to 0.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_attention", "convert_attention_tsse",
           "convert_causal_conv_block", "convert_causal_trans_conv_block",
           "convert_complex_sequence_model", "convert_deep_tsse",
           "convert_denoising_nppc", "convert_fullsubnet",
           "convert_fullsubnet_plus", "convert_image_net",
           "convert_image_unet", "convert_inpainting_nppc",
           "convert_inpainting_restoration", "convert_mosnet",
           "convert_multidirection", "convert_res_cnn", "convert_res_unet",
           "convert_self_attention", "image_net_leaves",
           "convert_sequence_model", "convert_tcn_block", "convert_tsse",
           "convert_unet",
           "convert_unet2", "random_denoising_nppc_params",
           "random_complex_sequence_params", "random_fullsubnet_params",
           "random_fullsubnet_plus_params", "random_image_net_params",
           "random_inpainting_nppc_params", "random_mosnet_params",
           "random_unet_params",
           "to_jax_fullsubnet", "to_jax_fullsubnet_plus", "to_jax_image_net",
           "to_jax_unet"]

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _conv1d(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(2, 1, 0)),
            f"{prefix}.bias": _t(p["bias"])}


def _pointwise(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T[:, :, None]),
            f"{prefix}.bias": _t(p["bias"])}


def convert_sequence_model(params: Mapping, prefix: str, kind: str,
                           num_layers: int = 2,
                           bidirectional: bool = False) -> StateDict:
    """recurrent.SequenceModel params -> the port's SequenceModel keys."""
    sd: StateDict = {}
    seq = f"{prefix}sequence_model"
    if kind in ("LSTM", "GRU"):     # the same names, 4H or 3H gate rows
        sd.update(_recurrent_layers(params, "layer_", seq, num_layers,
                                    bidirectional))
    elif kind in ("TCN", "TCN-subband"):
        for i in range(8):
            sd.update(convert_tcn_block(params["tcn"][f"block_{i}"],
                                        f"{seq}.{i}."))
    else:
        raise NotImplementedError(kind)
    sd.update(_dense(params["fc_output_layer"], f"{prefix}fc_output_layer"))
    return sd


def convert_tcn_block(params: Mapping, prefix: str = "") -> StateDict:
    """nn.tcn.TCNBlock params -> the port's TCNBlock keys."""
    sd: StateDict = {}
    sd.update(_pointwise(params["conv1x1"], f"{prefix}conv1x1"))
    sd.update(_conv1d(params["depthwise_conv"], f"{prefix}depthwise_conv"))
    sd.update(_pointwise(params["sconv"], f"{prefix}sconv"))
    for i in (1, 2):
        sd[f"{prefix}prelu{i}.weight"] = _t(params[f"prelu{i}"])
        sd[f"{prefix}norm{i}.weight"] = _t(params[f"norm{i}"]["scale"])
        sd[f"{prefix}norm{i}.bias"] = _t(params[f"norm{i}"]["bias"])
    return sd


def _recurrent_layers(params: Mapping, layer_prefix: str, module: str,
                      num_layers: int, bidirectional: bool) -> StateDict:
    """LSTM or GRU layers `{layer_prefix}{n}` -> torch.nn.LSTM's / GRU's
    names under `module`."""
    sd: StateDict = {}
    for layer in range(num_layers):
        p = params[f"{layer_prefix}{layer}"]
        for suffix in ([""] + (["_reverse"] if bidirectional else [])):
            sd[f"{module}.weight_ih_l{layer}{suffix}"] = _t(
                np.asarray(p[f"w_ih{suffix}"]).T)
            sd[f"{module}.weight_hh_l{layer}{suffix}"] = _t(
                np.asarray(p[f"w_hh{suffix}"]).T)
            sd[f"{module}.bias_ih_l{layer}{suffix}"] = _t(p[f"b_ih{suffix}"])
            sd[f"{module}.bias_hh_l{layer}{suffix}"] = _t(p[f"b_hh{suffix}"])
    return sd


def convert_complex_sequence_model(params: Mapping, prefix: str = "",
                                   num_layers: int = 2,
                                   bidirectional: bool = False) -> StateDict:
    """recurrent.ComplexSequenceModel params -> the port's keys
    ({real,imag}_sequence_model.weight_ih_l{n}..., {real,imag}_fc_output_layer):
    the inverse of generative_audio_tpu/utils/torch_convert.py:394-415."""
    sd: StateDict = {}
    for tower in ("real", "imag"):
        sd.update(_recurrent_layers(params, f"{tower}_layer_",
                                    f"{prefix}{tower}_sequence_model",
                                    num_layers, bidirectional))
        sd.update(_dense(params[f"{tower}_fc_output_layer"],
                         f"{prefix}{tower}_fc_output_layer"))
    return sd


_BRANCHES = ("smallConv1d", "middleConv1d", "largeConv1d")


def convert_tsse(params: Mapping, prefix: str) -> StateDict:
    """attention.ChannelTimeSenseSELayer (or ChannelTimeSenseSEWeightLayer)
    params -> the port's TSSE keys."""
    sd: StateDict = {}
    for branch in _BRANCHES:
        sd.update(_conv1d(params[branch]["conv"], f"{prefix}{branch}.0"))
    for name in ("feature_concate_fc", "fc1", "fc2"):
        sd.update(_dense(params[name], f"{prefix}{name}"))
    return sd


def _se(params: Mapping, prefix: str) -> StateDict:
    return {**_dense(params["fc1"], f"{prefix}fc1"),
            **_dense(params["fc2"], f"{prefix}fc2")}


def convert_self_attention(params: Mapping, prefix: str = "") -> StateDict:
    """attention.SelfAttentionLayer params -> q_linear, k_linear, v_linear,
    out."""
    sd: StateDict = {}
    for name in ("q_linear", "k_linear", "v_linear", "out"):
        sd.update(_dense(params[name], f"{prefix}{name}"))
    return sd


def convert_deep_tsse(params: Mapping, prefix: str = "") -> StateDict:
    """attention.ChannelDeepTimeSenseSELayer params -> the reference's keys
    (each branch's two convs at Sequential indices 0 and 2)."""
    sd: StateDict = {}
    for branch in _BRANCHES:
        sd.update(_conv1d(params[branch]["conv0"], f"{prefix}{branch}.0"))
        sd.update(_conv1d(params[branch]["conv1"], f"{prefix}{branch}.2"))
    sd.update(_dense(params["feature_concate_fc"],
                     f"{prefix}feature_concate_fc"))
    sd.update(_se(params, prefix))
    return sd


def convert_attention_tsse(params: Mapping, prefix: str = "") -> StateDict:
    """attention.ChannelTimeSenseAttentionSELayer params -> {branch}.conv1d,
    {branch}.attention.*, feature_concate_fc, fc1, fc2."""
    sd: StateDict = {}
    for branch in _BRANCHES:
        sd.update(_conv1d(params[branch]["conv1d"], f"{prefix}{branch}.conv1d"))
        sd.update(convert_self_attention(params[branch]["attention"],
                                         f"{prefix}{branch}.attention."))
    sd.update(_dense(params["feature_concate_fc"],
                     f"{prefix}feature_concate_fc"))
    sd.update(_se(params, prefix))
    return sd


def convert_attention(params: Mapping, prefix: str, kind: str) -> StateDict:
    """make_channel_attention's module params (SE, TSSE, CBAM or ECA) ->
    the port's keys."""
    if kind == "TSSE":
        return convert_tsse(params, prefix)
    if kind in ("SE", "CBAM"):
        return _se(params, prefix)
    if kind == "ECA":             # flax [k, 1, 1] -> Conv1d [1, 1, k]
        return {f"{prefix}conv.weight": _t(
            np.asarray(params["conv"]["kernel"]).transpose(2, 1, 0))}
    raise NotImplementedError(f"Unknown channel attention model {kind!r}")


def _uniform(rng, shape, fan_in):
    bound = fan_in ** -0.5
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _random_dense(rng, n_in, n_out):
    return {"kernel": _uniform(rng, (n_in, n_out), n_in),
            "bias": _uniform(rng, (n_out,), n_in)}


def _random_recurrent(rng, kind, n_in, h, n_out, num_layers=2):
    """A unidirectional recurrent SequenceModel's params: `num_layers` LSTM
    or GRU layers and the head, all uniform in +/-1/sqrt(H)."""
    gh = {"LSTM": 4, "GRU": 3}[kind] * h
    params = {}
    for layer in range(num_layers):
        size = n_in if layer == 0 else h
        params[f"layer_{layer}"] = {"w_ih": _uniform(rng, (size, gh), h),
                                    "w_hh": _uniform(rng, (h, gh), h),
                                    "b_ih": _uniform(rng, (gh,), h),
                                    "b_hh": _uniform(rng, (gh,), h)}
    params["fc_output_layer"] = _random_dense(rng, h, n_out)
    return params


def random_complex_sequence_params(kind: str, input_size: int, hidden: int,
                                   output_size: int, num_layers: int = 2,
                                   bidirectional: bool = False,
                                   seed: int = 0) -> Dict[str, Any]:
    """Random ComplexSequenceModel (LSTM or GRU towers) params in the JAX
    package's layout, made with numpy from `seed`: uniform in
    +/-1/sqrt(H), as torch initialises an RNN."""
    rng = np.random.default_rng(seed)
    gh = {"LSTM": 4, "GRU": 3}[kind] * hidden
    dirs = 2 if bidirectional else 1
    params: Dict[str, Any] = {}
    for tower in ("real", "imag"):
        for layer in range(num_layers):
            size = input_size if layer == 0 else hidden * dirs
            params[f"{tower}_layer_{layer}"] = {
                f"{kind_}{suffix}": _uniform(rng, shape, hidden)
                for suffix in [""] + ["_reverse"] * bidirectional
                for kind_, shape in (("w_ih", (size, gh)),
                                     ("w_hh", (hidden, gh)),
                                     ("b_ih", (gh,)), ("b_hh", (gh,)))}
        params[f"{tower}_fc_output_layer"] = {
            "kernel": _uniform(rng, (hidden * dirs, output_size), hidden),
            "bias": _uniform(rng, (output_size,), hidden)}
    return params


def random_fullsubnet_params(config, seed: int = 0) -> Dict[str, Any]:
    """Random FullSubNet (v1, GRU or LSTM) params in the JAX package's
    layout, made with numpy from `seed`: weights uniform in +/-1/sqrt(fan_in)
    as torch initialises them. `config` is a FullSubNetConfig of either
    package."""
    rng = np.random.default_rng(seed)
    c = config
    fb_w = 2 * c.fb_num_neighbors + 1
    sb_w = 2 * c.sb_num_neighbors + 1
    return {
        "fb_model": _random_recurrent(rng, c.sequence_model, c.num_freqs,
                                      c.fb_model_hidden_size, c.num_freqs),
        "sb_model": _random_recurrent(rng, c.sequence_model, sb_w + fb_w,
                                      c.sb_model_hidden_size, 2)}


def random_fullsubnet_plus_params(config, seed: int = 0) -> Dict[str, Any]:
    """Random FullSubNet+ (LSTM sub-band, the config's channel attention at
    its subband_num, TCN towers) params in the JAX package's layout, made
    with numpy from `seed`: weights uniform in +/-1/sqrt(fan_in) as torch
    initialises them, PReLU slopes 0.25, norm scales 1 and biases 0.
    `config` is a FullSubNetPlusConfig of either package."""
    return _random_plus_params(config, seed, config.num_freqs,
                               config.output_size)


def _random_plus_params(config, seed: int, fb_in: int,
                        sb_out: int) -> Dict[str, Any]:
    """random_fullsubnet_plus_params with the TCN towers over `fb_in`
    channels and `sb_out` sub-band outputs a bin."""
    rng = np.random.default_rng(seed)

    def u(shape, fan_in):
        return _uniform(rng, shape, fan_in)

    def dense(n_in, n_out):
        return _random_dense(rng, n_in, n_out)

    def conv(k, n_in_per_group, n_out):
        fan_in = k * n_in_per_group
        return {"kernel": u((k, n_in_per_group, n_out), fan_in),
                "bias": u((n_out,), fan_in)}

    c = config
    f, ch = c.num_freqs, c.num_channels
    in_per_group = ch // (ch // c.subband_num)     # TSSE's grouped convs

    def attention():
        # drawn in the module's parameter order, TSSE's as before the other
        # kinds were ported, so that a seed gives the same weights
        kind = c.channel_attention_model
        if kind == "ECA":
            return {"conv": {"kernel": u((3, 1, 1), 3)}}
        if kind not in ("SE", "CBAM", "TSSE"):
            raise NotImplementedError(
                f"Unknown channel attention model {kind!r}")
        p = {}
        if kind == "TSSE":
            for branch, k in zip(_BRANCHES, c.kersize):
                p[branch] = {"conv": conv(k, in_per_group, ch)}
            p["feature_concate_fc"] = dense(3, 1)
        p["fc1"] = dense(ch, ch // 2)
        p["fc2"] = dense(ch // 2, ch)
        return p

    params: Dict[str, Any] = {}
    for suffix in ("", "_real", "_imag"):
        params[f"channel_attention{suffix}"] = attention()
        hid = 512                  # SequenceModel's fixed TCN hidden width
        params[f"fb_model{suffix}"] = {
            "tcn": {f"block_{i}": {
                "conv1x1": dense(fb_in, hid),
                "prelu1": np.full((1,), 0.25, np.float32),
                "norm1": {"scale": np.ones(hid, np.float32),
                          "bias": np.zeros(hid, np.float32)},
                "depthwise_conv": conv(3, 1, hid),
                "prelu2": np.full((1,), 0.25, np.float32),
                "norm2": {"scale": np.ones(hid, np.float32),
                          "bias": np.zeros(hid, np.float32)},
                "sconv": dense(hid, fb_in)} for i in range(8)},
            "fc_output_layer": dense(fb_in, f)}
    n_in = (2 * c.sb_num_neighbors + 1) + 3 * (2 * c.fb_num_neighbors + 1)
    params["sb_model"] = _random_recurrent(
        rng, "LSTM", n_in, c.sb_model_hidden_size, sb_out)
    return params


def random_denoising_nppc_params(config, seed: int = 0) -> Dict[str, Any]:
    """Random DenoisingNPPCModel params in the JAX package's layout
    ({"pretrained_restoration_model": ..., "audio_pc_wrapper": {"net":
    ...}}), made with numpy: the enhancer from `seed`, the head from seed + 1
    (see random_fullsubnet_plus_params; the head's towers take the noisy
    and enhanced streams, 2 * num_freqs channels, and its sub-band model
    gives 2 * n_directions outputs). `config` is a DenoisingNPPCConfig of
    either package."""
    head = config.pc_wrapper
    return {
        "pretrained_restoration_model": random_fullsubnet_plus_params(
            config.restoration, seed),
        "audio_pc_wrapper": {"net": _random_plus_params(
            head, seed + 1, 2 * head.num_freqs, 2 * head.n_directions)}}


def convert_fullsubnet_plus(params: Mapping,
                            sequence_model: str = "LSTM",
                            attention: str = "TSSE") -> StateDict:
    """models.FullSubNetPlus params -> the port's FullSubNetPlus state_dict;
    `attention` is the config's channel_attention_model."""
    sd: StateDict = {}
    for suffix in ("", "_real", "_imag"):
        sd.update(convert_attention(params[f"channel_attention{suffix}"],
                                    f"channel_attention{suffix}.", attention))
        sd.update(convert_sequence_model(params[f"fb_model{suffix}"],
                                         f"fb_model{suffix}.", "TCN"))
    sd.update(convert_sequence_model(params["sb_model"], "sb_model.",
                                     sequence_model))
    return sd


def convert_fullsubnet(params: Mapping,
                       sequence_model: str = "LSTM") -> StateDict:
    """models.FullSubNet params -> the port's FullSubNet state_dict: the
    inverse of generative_audio_tpu/utils/torch_convert.py:170-176."""
    sd: StateDict = {}
    for name in ("fb_model", "sb_model"):
        sd.update(convert_sequence_model(params[name], f"{name}.",
                                         sequence_model))
    return sd


# the head has FullSubNet+'s parameter names (only some widths differ)
convert_multidirection = convert_fullsubnet_plus


def convert_denoising_nppc(params: Mapping) -> StateDict:
    """models.nppc_model.DenoisingNPPCModel params -> the port's
    DenoisingNPPCModel state_dict."""
    sd = {f"pretrained_restoration_model.{k}": v for k, v in
          convert_fullsubnet_plus(
              params["pretrained_restoration_model"]).items()}
    sd.update({f"audio_pc_wrapper.net.{k}": v for k, v in
               convert_multidirection(
                   params["audio_pc_wrapper"]["net"]).items()})
    return sd


# state-dict key (regex) -> (path in the JAX tree, transform of the array)
_LSTM_KINDS = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih",
               "bias_hh": "b_hh"}
_TO_JAX = [
    (r"(channel_attention\w*)\.(\w+Conv1d)\.0\.weight",
     lambda m: (m[1], m[2], "conv", "kernel"), lambda a: a.transpose(2, 1, 0)),
    (r"(channel_attention\w*)\.(\w+Conv1d)\.0\.bias",
     lambda m: (m[1], m[2], "conv", "bias"), None),
    (r"(\w+)\.sequence_model\.(\d)\.(conv1x1|sconv)\.weight",
     lambda m: (m[1], "tcn", f"block_{m[2]}", m[3], "kernel"),
     lambda a: a[:, :, 0].T),
    (r"(\w+)\.sequence_model\.(\d)\.depthwise_conv\.weight",
     lambda m: (m[1], "tcn", f"block_{m[2]}", "depthwise_conv", "kernel"),
     lambda a: a.transpose(2, 1, 0)),
    (r"(\w+)\.sequence_model\.(\d)\.(conv1x1|sconv|depthwise_conv)\.bias",
     lambda m: (m[1], "tcn", f"block_{m[2]}", m[3], "bias"), None),
    (r"(\w+)\.sequence_model\.(\d)\.(prelu[12])\.weight",
     lambda m: (m[1], "tcn", f"block_{m[2]}", m[3]), None),
    (r"(\w+)\.sequence_model\.(\d)\.(norm[12])\.weight",
     lambda m: (m[1], "tcn", f"block_{m[2]}", m[3], "scale"), None),
    (r"(\w+)\.sequence_model\.(\d)\.(norm[12])\.bias",
     lambda m: (m[1], "tcn", f"block_{m[2]}", m[3], "bias"), None),
    (r"(\w+)\.sequence_model\.(weight|bias)_(ih|hh)_l(\d)(_reverse)?",
     lambda m: (m[1], f"layer_{m[4]}",
                _LSTM_KINDS[f"{m[2]}_{m[3]}"] + (m[5] or "")),
     lambda a: a.T),                      # biases are 1-D: .T leaves them
    (r"([\w.]+)\.weight", lambda m: (*m[1].split("."), "kernel"),
     lambda a: a.T),                      # Linear
    (r"([\w.]+)\.bias", lambda m: (*m[1].split("."), "bias"), None),
]


def to_jax_fullsubnet_plus(named: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's FullSubNetPlus or FullSubNet tensors by state-dict name
    (parameters, or their gradients) -> float32 numpy arrays in the JAX
    package's nested param layout: the inverse of convert_fullsubnet_plus
    and of convert_fullsubnet (the key patterns cover both models)."""
    tree: Dict[str, Any] = {}
    for key, value in named.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        array = np.asarray(value, dtype=np.float32)
        for pattern, path_of, transform in _TO_JAX:
            m = re.fullmatch(pattern, key)
            if m:
                break
        else:
            raise KeyError(f"no JAX counterpart for state-dict key {key!r}")
        *parents, leaf = path_of(m)
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(
            transform(array) if transform else array)
    return tree


to_jax_fullsubnet = to_jax_fullsubnet_plus


# ------------------------------------------------------------------ UNets --
# the UNet's blocks: (JAX path, state-dict prefix of its DoubleConv's
# Sequential)
_UNET_BLOCKS = ([(("inc",), "inc.conv")]
                + [((f"down{i}", "conv"), f"down{i}.mpconv.1.conv")
                   for i in range(1, 5)]
                + [((f"up{i}", "conv"), f"up{i}.conv.conv")
                   for i in range(1, 5)])
# DoubleConv: flax name -> index in the reference's Sequential
_DOUBLE_CONV = {"conv0": 0, "bn0": 1, "conv1": 3, "bn1": 4}
_UNET2_BLOCKS = ([f"enc{i}" for i in range(1, 7)]
                 + [f"dec{i}" for i in range(6, 0, -1)])


def _node(tree: Mapping, path) -> Mapping:
    for name in path:
        tree = tree[name]
    return tree


def _conv2d(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            f"{prefix}.bias": _t(p["bias"])}


def _bn(p: Mapping, stats: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(stats["mean"]),
            f"{prefix}.running_var": _t(stats["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def convert_unet(variables: Mapping, prefix: str = "") -> StateDict:
    """nn.unet.UNet variables {"params", "batch_stats"} -> the port's UNet
    state_dict (keys under `prefix`)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for path, seq in _UNET_BLOCKS:
        p, st = _node(params, path), _node(stats, path)
        for name, index in _DOUBLE_CONV.items():
            key = f"{prefix}{seq}.{index}"
            sd.update(_bn(p[name], st[name], key) if name.startswith("bn")
                      else _conv2d(p[name], key))
    sd.update(_conv2d(params["outc"], f"{prefix}outc.conv"))
    return sd


def convert_unet2(variables: Mapping, prefix: str = "") -> StateDict:
    """nn.unet.UNet2 variables -> the port's UNet2 state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for block in _UNET2_BLOCKS:
        sd.update(_conv2d(params[block]["conv"], f"{prefix}{block}.conv"))
        sd.update(_bn(params[block]["bn"], stats[block]["bn"],
                      f"{prefix}{block}.bn"))
    return sd


def _sub(variables: Mapping, name: str) -> Dict[str, Any]:
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def convert_inpainting_restoration(variables: Mapping) -> StateDict:
    """models.nppc_model.InpaintingRestorationModel variables -> the port's
    InpaintingRestorationModel state_dict."""
    return convert_unet(_sub(variables, "net"), "net.")


def convert_inpainting_nppc(variables: Mapping) -> StateDict:
    """models.nppc_model.InpaintingNPPCModel variables -> the port's
    InpaintingNPPCModel state_dict."""
    sd = {f"pretrained_restoration_model.{k}": v for k, v in
          convert_inpainting_restoration(
              _sub(variables, "pretrained_restoration_model")).items()}
    sd.update(convert_unet(_sub(_sub(variables, "pc_wrapper"), "net"),
                           "pc_wrapper.net."))
    return sd


def random_unet_params(in_channels: int, out_channels: int,
                       seed: int = 0) -> Dict[str, Any]:
    """Random nn.unet.UNet variables in the JAX layout, made with numpy from
    `seed`: kernels and biases uniform in +/-1/sqrt(fan_in) as torch
    initialises them, BatchNorm scales 1 and biases 0, running means 0 and
    variances 1."""
    rng = np.random.default_rng(seed)

    def conv(k, n_in, n_out):
        fan_in = k * k * n_in
        return {"kernel": _uniform(rng, (k, k, n_in, n_out), fan_in),
                "bias": _uniform(rng, (n_out,), fan_in)}

    def double(n_in, n_out):
        ones, zeros = np.ones(n_out, np.float32), np.zeros(n_out, np.float32)
        bn = {"scale": ones, "bias": zeros}
        return ({"conv0": conv(3, n_in, n_out), "bn0": bn,
                 "conv1": conv(3, n_out, n_out), "bn1": dict(bn)},
                {"bn0": {"mean": zeros, "var": ones},
                 "bn1": {"mean": zeros.copy(), "var": ones.copy()}})

    widths = {"inc": (in_channels, 64), "down1": (64, 128),
              "down2": (128, 256), "down3": (256, 512), "down4": (512, 512),
              "up1": (1024, 256), "up2": (512, 128), "up3": (256, 64),
              "up4": (128, 64)}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, (n_in, n_out) in widths.items():
        p, st = double(n_in, n_out)
        params[name], stats[name] = ((p, st) if name == "inc"
                                     else ({"conv": p}, {"conv": st}))
    params["outc"] = conv(1, 64, out_channels)
    return {"params": params, "batch_stats": stats}


def random_inpainting_nppc_params(config, seed: int = 0) -> Dict[str, Any]:
    """Random InpaintingNPPCModel variables in the JAX layout, made with
    numpy: the restoration UNet from `seed`, the PC UNet from seed + 1 (see
    random_unet_params). `config` is an InpaintingNPPCConfig of either
    package."""
    r, h = config.restoration, config.pc_wrapper
    rest = random_unet_params(r.in_channels, r.out_channels, seed)
    head = random_unet_params(h.in_channels, h.n_dirs, seed + 1)
    return {"params": {"pretrained_restoration_model": {"net": rest["params"]},
                       "pc_wrapper": {"net": head["params"]}},
            "batch_stats": {
                "pretrained_restoration_model": {"net": rest["batch_stats"]},
                "pc_wrapper": {"net": head["batch_stats"]}}}


def to_jax_unet(named: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The port's UNet tensors by state-dict name under `prefix` (parameters
    and buffers, or parameters' gradients) -> {"params": ..., "batch_stats":
    ...} of float32 numpy arrays in the JAX layout; names absent from
    `named` are left out. The inverse of convert_unet."""
    def get(key):
        value = named.get(prefix + key)
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        return None if value is None else np.asarray(value, np.float32)

    def put(tree, path, leaf, value):
        if value is not None:
            for name in path:
                tree = tree.setdefault(name, {})
            tree[leaf] = np.ascontiguousarray(value)

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    blocks = _UNET_BLOCKS + [((), "outc.conv")]
    for path, seq in blocks:
        for name, index in (_DOUBLE_CONV.items() if path else [(None, None)]):
            key = seq if index is None else f"{seq}.{index}"
            where = path + ((name,) if name else ("outc",))
            if name and name.startswith("bn"):
                put(params, where, "scale", get(f"{key}.weight"))
                put(params, where, "bias", get(f"{key}.bias"))
                put(stats, where, "mean", get(f"{key}.running_mean"))
                put(stats, where, "var", get(f"{key}.running_var"))
            else:
                w = get(f"{key}.weight")
                put(params, where, "kernel",
                    None if w is None else w.transpose(2, 3, 1, 0))
                put(params, where, "bias", get(f"{key}.bias"))
    return {"params": params, "batch_stats": stats}


# ------------------------------------------------- causal blocks, MOSNet --
def convert_causal_conv_block(variables: Mapping, prefix: str = "") -> StateDict:
    """nn.tcn.CausalConvBlock variables {"params", "batch_stats"} -> the
    port's CausalConvBlock state_dict (conv, norm)."""
    params, stats = variables["params"], variables["batch_stats"]
    return {**_conv2d(params["conv"], f"{prefix}conv"),
            **_bn(params["norm"], stats["norm"], f"{prefix}norm")}


def convert_causal_trans_conv_block(variables: Mapping,
                                    prefix: str = "") -> StateDict:
    """nn.tcn.CausalTransConvBlock variables -> the port's state_dict. flax's
    ConvTranspose correlates with its kernel as it is and torch's
    conv_transpose2d with the kernel flipped, so both spatial axes are
    flipped here."""
    params, stats = variables["params"], variables["batch_stats"]
    kernel = np.asarray(params["conv"]["kernel"])[::-1, ::-1]
    return {f"{prefix}conv.weight": _t(kernel.transpose(2, 3, 0, 1)),
            f"{prefix}conv.bias": _t(params["conv"]["bias"]),
            **_bn(params["norm"], stats["norm"], f"{prefix}norm")}


def convert_mosnet(params: Mapping) -> StateDict:
    """eval.mosnet.MOSNet params (HWIO convs, the packed [D + H + 1, 4H]
    LSTM directions, dense1, frame) -> the port's MOSNet state_dict."""
    sd: StateDict = {}
    for name, p in params.items():
        if name.startswith("conv"):
            sd.update(_conv2d(p, name))
        elif name in ("lstm_fwd", "lstm_bwd"):
            sd[name] = _t(p)
        else:
            sd.update(_dense(p, name))
    return sd


def random_mosnet_params(config, seed: int = 0) -> Dict[str, Any]:
    """Random MOSNet params in the JAX layout, made with numpy from `seed`:
    kernels and biases uniform in +/-1/sqrt(fan_in). `config` is a
    MOSNetConfig of either package."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    in_ch = 1
    for bi, ch in enumerate(config.conv_channels):
        for ci in range(3):
            fan_in = 9 * in_ch
            params[f"conv{bi}_{ci}"] = {
                "kernel": _uniform(rng, (3, 3, in_ch, ch), fan_in),
                "bias": _uniform(rng, (ch,), fan_in)}
            in_ch = ch
    h = config.lstm_units
    d = config.reduced_freqs * config.conv_channels[-1]
    for name in ("lstm_fwd", "lstm_bwd"):
        params[name] = np.concatenate([_uniform(rng, (d, 4 * h), d),
                                       _uniform(rng, (h + 1, 4 * h), h)])
    params["dense1"] = _random_dense(rng, 2 * h, config.dense_units)
    params["frame"] = _random_dense(rng, config.dense_units, 1)
    return params


# ------------------------------------------------------------- image nets --
# Each image net's params as leaves (JAX path, state-dict prefix, kind,
# optional): kind "conv" is a Conv2d ({kernel, bias} <-> weight, bias),
# "gn" a GroupNorm ({scale, bias} <-> weight, bias), "qkv" and "proj" the
# attention's 1x1 Conv1d as a Dense ({kernel} <-> weight [O, I, 1], and the
# bias for "proj"); an optional leaf is the ResBlock's shortcut, present
# where its channels change. The index arithmetic is that of
# generative_audio_tpu/utils/torch_convert.py:222-391.
def _res_leaves(path, prefix):
    return [(path + ("conv1",), f"{prefix}.block.base.0", "conv", False),
            (path + ("norm1",), f"{prefix}.block.base.1", "gn", False),
            (path + ("conv2",), f"{prefix}.block.base.3", "conv", False),
            (path + ("norm2",), f"{prefix}.block.base.4", "gn", False),
            (path + ("shortcut",), f"{prefix}.block.shortcut", "conv", True)]


def _attn_leaves(path, prefix):
    return [(path + ("conv_in",), f"{prefix}.conv_in", "qkv", False),
            (path + ("conv_out",), f"{prefix}.conv_out", "proj", False)]


def _upscale_leaves(net, prefix, first):
    """The upscale convs at `first`, `first` + 2, ...; and the index after
    them."""
    n = int(np.log2(net.upscale_factor))
    return ([((f"upscale_{fi}",), f"{prefix}.{first + 2 * fi}", "conv", False)
             for fi in range(n)], first + 2 * n)


def image_net_leaves(net):
    """The leaves of an ImageUNet, ResUNet or ResCNN of either package
    (the fields channels_list, downsample_list, attn_list, n_blocks,
    n_blocks_bottleneck, upscale_factor are read)."""
    kind = type(net).__name__
    if kind == "ImageUNet":
        leaves = [(("in_conv",), "encoder_blocks.0.0", "conv", False)]
        for i, down in enumerate(net.downsample_list):
            for j in range(net.n_blocks):
                at, k = f"encoder_blocks.{1 + i}", int(down) + 3 * j
                leaves += [((f"enc_{i}_{j}", "conv"), f"{at}.{k}", "conv",
                            False),
                           ((f"enc_{i}_{j}", "norm"), f"{at}.{k + 1}", "gn",
                            False)]
        for j in range(net.n_blocks_bottleneck):
            leaves += [((f"bottleneck_{j}", "conv"), f"bottleneck.{3 * j}",
                        "conv", False),
                       ((f"bottleneck_{j}", "norm"), f"bottleneck.{3 * j + 1}",
                        "gn", False)]
        n_levels = len(net.channels_list)
        for idx in range(n_levels):
            for j in range(net.n_blocks):
                at = f"decoder_blocks.{idx}"
                leaves += [((f"dec_{idx}_{j}", "conv"), f"{at}.{3 * j}",
                            "conv", False),
                           ((f"dec_{idx}_{j}", "norm"), f"{at}.{3 * j + 1}",
                            "gn", False)]
        ups, k = _upscale_leaves(net, f"decoder_blocks.{n_levels}", 0)
        return leaves + ups + [(("out_conv",), f"decoder_blocks.{n_levels}.{k}",
                                "conv", False)]
    if kind == "ResUNet":
        leaves = [(("in_conv",), "encoder_blocks.0.0", "conv", False)]
        enc = 1
        for i, (down, attn) in enumerate(zip(net.downsample_list,
                                             net.attn_list)):
            if down:
                leaves.append(((f"down_{i}",), f"encoder_blocks.{enc}.0",
                               "conv", False))
                enc += 1
            for j in range(net.n_blocks):
                leaves += _res_leaves((f"enc_{i}_{j}",),
                                      f"encoder_blocks.{enc}.0")
                if attn:
                    leaves += _attn_leaves((f"enc_attn_{i}_{j}",),
                                           f"encoder_blocks.{enc}.1")
                enc += 1
        leaves += (_res_leaves(("bottleneck_res1",), "bottleneck.0")
                   + _attn_leaves(("bottleneck_attn",), "bottleneck.1")
                   + _res_leaves(("bottleneck_res2",), "bottleneck.2"))
        dec = 0
        for i in reversed(range(len(net.channels_list))):
            attn = net.attn_list[i]
            for j in range(net.n_blocks):
                leaves += _res_leaves((f"dec_{i}_{j}",),
                                      f"decoder_blocks.{dec}.0")
                if attn:
                    leaves += _attn_leaves((f"dec_attn_{i}_{j}",),
                                           f"decoder_blocks.{dec}.1")
                dec += 1
            if net.downsample_list[i]:
                leaves += _res_leaves((f"up_res_{i}",),
                                      f"decoder_blocks.{dec}.0")
                if attn:
                    leaves += _attn_leaves((f"up_attn_{i}",),
                                           f"decoder_blocks.{dec}.1")
                leaves.append(((f"up_conv_{i}",),
                               f"decoder_blocks.{dec}.{3 if attn else 2}",
                               "conv", False))
                dec += 1
        final = f"decoder_blocks.{dec}"
        leaves += _res_leaves(("out_res",), f"{final}.0")
        leaves.append((("out_norm",), f"{final}.1", "gn", False))
        ups, k = _upscale_leaves(net, final, 3)
        return leaves + ups + [(("out_conv",), f"{final}.{k}", "conv", False)]
    if kind == "ResCNN":
        leaves = [(("in_conv",), "net.0", "conv", False)]
        for i in range(net.n_blocks):
            leaves += [((f"block_{i}_conv1",), f"net.{1 + i}.base.0", "conv",
                        False),
                       ((f"block_{i}_conv2",), f"net.{1 + i}.base.2", "conv",
                        False)]
        leaves.append((("mid_conv",), f"net.{1 + net.n_blocks}", "conv", False))
        # net.{n + 2} is the empty ShortcutBlock: it holds no params
        ups, k = _upscale_leaves(net, "net", 3 + net.n_blocks)
        return leaves + ups + [(("out_conv",), f"net.{k}", "conv", False)]
    raise TypeError(f"not an image net: {kind}")


def convert_image_net(params: Mapping, net, prefix: str = "") -> StateDict:
    """The JAX params of an image net ({"params": ...} or the tree inside
    it) -> the port's state_dict under `prefix`. `net` is the net of either
    package (its fields lay out the names). The inverse of
    generative_audio_tpu/utils/torch_convert.convert_image_unet,
    convert_res_unet and convert_res_cnn."""
    params = params.get("params", params)
    sd: StateDict = {}
    for path, key, kind, optional in image_net_leaves(net):
        if optional and path[0] in params and path[-1] not in _node(
                params, path[:-1]):
            continue
        p = _node(params, path)
        key = prefix + key
        if kind == "conv":
            sd.update(_conv2d(p, key))
        elif kind == "gn":
            sd[f"{key}.weight"], sd[f"{key}.bias"] = (_t(p["scale"]),
                                                      _t(p["bias"]))
        else:
            sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
            if kind == "proj":
                sd[f"{key}.bias"] = _t(p["bias"])
    return sd


def convert_image_unet(params: Mapping, net, prefix: str = "") -> StateDict:
    """image_nets.ImageUNet params -> the port's ImageUNet state_dict."""
    return convert_image_net(params, net, prefix)


def convert_res_unet(params: Mapping, net, prefix: str = "") -> StateDict:
    """image_nets.ResUNet params -> the port's ResUNet state_dict."""
    return convert_image_net(params, net, prefix)


def convert_res_cnn(params: Mapping, net, prefix: str = "") -> StateDict:
    """image_nets.ResCNN params -> the port's ResCNN state_dict."""
    return convert_image_net(params, net, prefix)


def to_jax_image_net(named: Mapping[str, Any], net,
                     prefix: str = "") -> Dict[str, Any]:
    """The port's image-net tensors by state-dict name under `prefix`
    (parameters, or their gradients) -> {"params": ...} of float32 numpy
    arrays in the JAX layout; names absent from `named` are left out. The
    inverse of convert_image_net."""
    def get(key):
        value = named.get(prefix + key)
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        return None if value is None else np.asarray(value, np.float32)

    params: Dict[str, Any] = {}
    for path, key, kind, _ in image_net_leaves(net):
        w, b = get(f"{key}.weight"), get(f"{key}.bias")
        if w is None and b is None:
            continue
        node = params
        for name in path:
            node = node.setdefault(name, {})
        if w is not None:
            node["scale" if kind == "gn" else "kernel"] = np.ascontiguousarray(
                w.transpose(2, 3, 1, 0) if kind == "conv" else
                w if kind == "gn" else w[:, :, 0].T)
        if b is not None:
            node["bias"] = b
    return {"params": params}


def random_image_net_params(net, seed: int = 0) -> Dict[str, Any]:
    """Random params of the port's image net `net` in the JAX layout
    ({"params": ...}), made with numpy from `seed`: conv and attention
    kernels and biases uniform in +/-1/sqrt(fan_in) as torch initialises
    them, GroupNorm scales 1 + u and biases u with u uniform in +/-0.1, so
    that a swap of the two shows."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    sd = {}
    for _, key, kind, optional in image_net_leaves(net):
        w = f"{key}.weight"
        if optional and w not in shapes:
            continue
        if kind == "gn":
            sd[w] = (1 + rng.uniform(-0.1, 0.1, shapes[w])).astype(np.float32)
            sd[f"{key}.bias"] = rng.uniform(-0.1, 0.1, shapes[w]).astype(
                np.float32)
            continue
        fan_in = int(np.prod(shapes[w][1:]))
        sd[w] = _uniform(rng, shapes[w], fan_in)
        if kind != "qkv":
            sd[f"{key}.bias"] = _uniform(rng, shapes[w][:1], fan_in)
    return to_jax_image_net(sd, net)
