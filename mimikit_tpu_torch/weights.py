"""Carry trained weights between the JAX package and the port.

``samplernn_state_dict_from_jax`` turns a ``mimikit_tpu`` SampleRNN parameter
tree — nested dicts of numpy arrays, as ``jax.device_get(net.params)`` gives
it — into the port's state_dict.  It is the inverse of
``mimikit_tpu/migrate.py:samplernn_params_from_state_dict``: dense kernels
are transposed to torch's (out, in) layout, the bottom tier's flattened
(k, out) kernel becomes a (out, 1, k) conv weight, the four per-gate LSTM
kernels are packed i|f|g|o, and the flax cell's single hidden bias goes into
``bias_hh`` with ``bias_ih`` zero (``migrate`` sums the two back).
``samplernn_params_to_jax`` is its inverse (the checkpoint writer's map): the
port's state_dict -> the flax tree of numpy arrays, with the LSTM's one
bias ``bias_hh + bias_ih`` on the hidden projections.  A weight-normed net's
layers carry flax's own parametrisation both ways: the wrapped kernel is the
port's ``_v`` (transposed as a plain kernel is) and the scale of the sibling
``WeightNorm_{k}`` collection (key ``Dense_{k}/kernel/scale``; an LSTM
layer's ``cells_{l}``, keys ``l{l}/{i|h}{gate}/kernel/scale``) its ``_g``
(``mimikit_tpu/migrate.py:305-325`` reads that layout).  Carrying the kernel
and the scale, not the effective weight, keeps both packages' optimisers on
the same parameters.

``wavenet_state_dict_from_jax`` and ``wavenet_params_to_jax`` do the same
for WaveNet, the inverse pair of ``migrate.py:wavenet_params_from_state_dict``:
a flax conv kernel (k, in, out) is a torch conv weight (out, in, k), a dense
kernel (in, out) a linear weight (out, in), the embedding table is shared
as it is.

A WaveNet on frames (FreqNet: ``IOSpec.magspec_io``) has dense input and
output heads: flax's ``input_modules_{j}/core/Dense_0`` and
``output_modules_{j}/core/Dense_0`` are the port's ``input_modules.{j}.0``
and ``output_modules.{j}.0``, as ``migrate`` maps a framed-linear input.

``seq2seq_state_dict_from_jax`` and ``seq2seq_params_to_jax`` do the same for
``Seq2SeqLSTMNetwork`` under PyTorch mimikit's names, which
``migrate.py:seq2seq_params_from_state_dict`` reads (``:523-600``): each
``_BiLSTMSum``'s ``fwd``/``bwd`` cell is ``{enc,dec}.lstm.{n}.*_l0`` and
``*_l0_reverse`` (per-gate kernels packed i|f|g|o, the cell's one bias in
``bias_hh``), ``enc/fc_out`` is ``enc.fc_out.weight``, a linear resampler
``{enc,dec}.fc.fc.*``, the output heads ``output_module.heads.{i}.0.*`` and
dense or embedding input heads ``input_module.heads.{j}.0.*``.
``migrate``'s map takes only nets built with ``ref_compat=True`` (the
reference's own function); these two carry any net's parameters, whatever
its ``ref_compat``.

``transformer_state_dict_from_jax`` and ``transformer_params_to_jax`` do the
same for SimpleTransformer, the inverse pair of
``migrate.py:transformer_params_from_state_dict``: flax's q/k/v kernels (d, nH,
dH) become the rows of torch's packed ``in_proj_weight`` (3d, d), the out
kernel (nH, dH, d) ``out_proj.weight`` (d, d), ``ln{k}`` ``norm{k}``, and the
final norm ``model.norm``.

``jukebox_state_dict_from_jax`` and ``jukebox_params_to_jax`` do the same for
JukeBox under the names of PyTorch mimikit's JukeBox, which ``migrate``
reads for it (``migrate.py:467-492,378-414``): tier i's decoder layers are
``tiers.{i}.model.layers.{l}.*`` (SimpleTransformer's per-layer names), its
framed dense ``tiers.{i}.input_module.heads.{j}.2``, its up-sampler
``tiers.{i}.up_sampler.fc``, and the bottom tier's framed conv
``tiers.{n-1}.input_module.heads.{j}.2.2.cv.weight`` (out, 1, k), the flax
(k, out) kernel transposed.

``tiedae_state_dict_from_jax`` and ``tiedae_params_to_jax`` do the same for
``TiedAE`` (``migrate.py`` has no map for it): flax's shared kernel ``w{i}``
(k, d_in, d_out) is the conv weight ``kernels.{i}`` (d_out, d_in, k), the
heads ``{input,output}_modules_{j}/core/Dense_0`` (an embedding input's
``Embed_0``) are ``{input,output}_modules.{j}.0``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "samplernn_state_dict_from_jax",
    "samplernn_params_to_jax",
    "wavenet_state_dict_from_jax",
    "wavenet_params_to_jax",
    "seq2seq_state_dict_from_jax",
    "seq2seq_params_to_jax",
    "transformer_state_dict_from_jax",
    "transformer_params_to_jax",
    "jukebox_state_dict_from_jax",
    "jukebox_params_to_jax",
    "tiedae_state_dict_from_jax",
    "tiedae_params_to_jax",
]

_GATES = "ifgo"


def _wn_scale(node: Mapping, layer: str):
    """The scale flax's ``WeightNorm`` keeps for ``node[layer]``'s kernel (in a
    sibling ``WeightNorm_*`` collection), or None for a plain layer."""
    for name, coll in node.items():
        if name.startswith("WeightNorm_") and f"{layer}/kernel/scale" in coll:
            return np.asarray(coll[f"{layer}/kernel/scale"])
    return None


def samplernn_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SampleRNN params -> the port's ``SampleRNN`` state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    n_tiers = sum(1 for k in params if re.fullmatch(r"tier_inputs_\d+", k))

    def dense(prefix, node, layer):
        d, scale = node[layer], _wn_scale(node, layer)
        if scale is None:
            sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
        else:
            sd[f"{prefix}.weight_g"] = scale
            sd[f"{prefix}.weight_v"] = np.asarray(d["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(d["bias"])

    for i in range(n_tiers):
        tin = params[f"tier_inputs_{i}"]
        if "weights" in tin:
            sd[f"tiers.{i}.input_module.weights"] = np.asarray(tin["weights"])
        for name, head in tin.items():
            m = re.fullmatch(r"heads_(\d+)", name)
            if not m:
                continue
            base = f"tiers.{i}.input_module.heads.{m.group(1)}.2"
            core = head["core"]
            if "Dense_0" in core:
                dense(base, core, "Dense_0")
            else:
                d = core["Conv1dResampler_0"]["Dense_0"]
                kernel = np.asarray(d["kernel"])  # (k * c, out), c == 1
                k, out = kernel.shape
                sd[f"{base}.2.cv.weight"] = kernel.reshape(k, 1, out).transpose(2, 1, 0)
                sd[f"{base}.2.cv.bias"] = np.asarray(d["bias"])
        if f"rnn_t{i}" in params:
            stack = params[f"rnn_t{i}"]
            for name, cell in stack.items():
                if not re.fullmatch(r"l\d+", name):
                    continue  # cells_{l}: the layer's weight-norm scales, read below
                layer = int(name[1:])
                pre = f"tiers.{i}.rnn"
                scales = stack.get(f"cells_{layer}")
                for p in "ih":
                    w = f"{pre}.weight_{p}h_l{layer}"
                    kernel = np.concatenate(
                        [np.asarray(cell[f"{p}{g}"]["kernel"]).T for g in _GATES])
                    if scales is None:
                        sd[w] = kernel
                    else:
                        sd[f"{w}_v"] = kernel
                        sd[f"{w}_g"] = np.concatenate(
                            [np.asarray(scales[f"{name}/{p}{g}/kernel/scale"]) for g in _GATES])
                b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
                sd[f"{pre}.bias_hh_l{layer}"] = b
                sd[f"{pre}.bias_ih_l{layer}"] = np.zeros_like(b)
        if f"up_t{i}" in params:
            dense(f"tiers.{i}.up_sampler.fc", params[f"up_t{i}"], "Dense_0")
    for name, out in params.items():
        m = re.fullmatch(r"outputs_(\d+)", name)
        if not m:
            continue
        core = out["estimator"]["core"]
        for dname in core:
            if dname.startswith("Dense_"):
                k = int(dname.split("_")[1])
                dense(f"output_modules.{m.group(1)}.estimator.0.fc.{2 * k}", core, dname)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in sd.items()
    }


def samplernn_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``SampleRNN`` state_dict -> the JAX SampleRNN parameter
    tree (nested dicts of f32 numpy arrays)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}

    def put(path, arr):
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)

    def scale(node_path, key, arr):
        """A weight-norm scale: ``key`` holds '/' and is one leaf's name."""
        node = tree
        for p in node_path.split("/"):
            node = node.setdefault(p, {})
        node[key] = np.ascontiguousarray(arr)

    def dense(path, prefix):
        """``path``: the flax Dense (``.../Dense_{k}``); under weight norm its
        scale goes to the sibling ``WeightNorm_{k}``."""
        if f"{prefix}.weight_v" in sd:
            parent, layer = path.rsplit("/", 1)
            put(f"{path}/kernel", sd[f"{prefix}.weight_v"].T)
            scale(f"{parent}/WeightNorm_{layer.split('_')[1]}", f"{layer}/kernel/scale",
                  sd[f"{prefix}.weight_g"])
        else:
            put(f"{path}/kernel", sd[f"{prefix}.weight"].T)
        put(f"{path}/bias", sd[f"{prefix}.bias"])

    for key in sd:
        m = re.fullmatch(r"tiers\.(\d+)\.input_module\.heads\.(\d+)\.2\.weight(_v)?", key)
        if m:
            i, j, _ = m.groups()
            dense(f"tier_inputs_{i}/heads_{j}/core/Dense_0", key.rsplit(".", 1)[0])
            continue
        m = re.fullmatch(r"tiers\.(\d+)\.input_module\.heads\.(\d+)\.2\.2\.cv\.weight", key)
        if m:
            i, j = m.groups()
            w = sd[key]  # (out, 1, k) -> (k * 1, out)
            out, c, k = w.shape
            base = f"tier_inputs_{i}/heads_{j}/core/Conv1dResampler_0/Dense_0"
            put(f"{base}/kernel", w.transpose(2, 1, 0).reshape(k * c, out))
            put(f"{base}/bias", sd[key[: -len(".weight")] + ".bias"])
            continue
        m = re.fullmatch(r"tiers\.(\d+)\.input_module\.weights", key)
        if m:
            put(f"tier_inputs_{m.group(1)}/weights", sd[key])
            continue
        m = re.fullmatch(r"tiers\.(\d+)\.rnn\.weight_ih_l(\d+)(_v)?", key)
        if m:
            i, layer, wn = m.groups()
            pre, base = f"tiers.{i}.rnn", f"rnn_t{i}/l{layer}"
            sfx = "_v" if wn else ""
            w = {"i": sd[key], "h": sd[f"{pre}.weight_hh_l{layer}{sfx}"]}
            b = sd[f"{pre}.bias_hh_l{layer}"] + sd[f"{pre}.bias_ih_l{layer}"]
            H = w["h"].shape[1]
            for n, g in enumerate(_GATES):
                rows = slice(n * H, (n + 1) * H)
                for p in "ih":
                    put(f"{base}/{p}{g}/kernel", w[p][rows].T)
                    if wn:
                        scale(f"rnn_t{i}/cells_{layer}", f"l{layer}/{p}{g}/kernel/scale",
                              sd[f"{pre}.weight_{p}h_l{layer}_g"][rows])
                put(f"{base}/h{g}/bias", b[rows])
            continue
        m = re.fullmatch(r"tiers\.(\d+)\.up_sampler\.fc\.weight(_v)?", key)
        if m:
            dense(f"up_t{m.group(1)}/Dense_0", key.rsplit(".", 1)[0])
            continue
        m = re.fullmatch(r"output_modules\.(\d+)\.estimator\.0\.fc\.(\d+)\.weight(_v)?",
                         key)
        if m:
            j, k, _ = m.groups()
            dense(f"outputs_{j}/estimator/core/Dense_{int(k) // 2}", key.rsplit(".", 1)[0])
    return tree


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def _put(tree: Dict, path: str, arr: np.ndarray) -> None:
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.ascontiguousarray(arr)


def _conv_t(kernel) -> np.ndarray:
    """flax (k, in, out) <-> torch (out, in, k): the same transpose both ways."""
    return np.asarray(kernel).transpose(2, 1, 0)


def _dense_from_jax(node: Mapping, base: str, sd: Dict[str, np.ndarray]) -> None:
    """A flax Dense (kernel (in, out), bias) -> ``{base}.weight`` (out, in)
    and ``{base}.bias``."""
    sd[f"{base}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        sd[f"{base}.bias"] = np.asarray(node["bias"])


def _dense_to_jax(tree: Dict, path: str, what: str, v: np.ndarray) -> None:
    _put(tree, f"{path}/{'kernel' if what == 'weight' else 'bias'}",
         v.T if what == "weight" else v)


# WaveNet layer submodules: flax name pattern -> the port's module path
_WN_LAYER = (
    (r"conv_dil(\d+)", "conv_dil.{}.0", True),
    (r"conv_1x1_(\d+)", "conv_1x1.{}.0", True),
    (r"conv_(skip|res)", "conv_{}", True),
    (r"aff_res()", "aff_res", False),
)


def wavenet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX WaveNet params -> the port's ``WaveNet`` state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"input_modules_(\d+)", name)
        if m:
            core = node["core"]
            if "Embed_0" in core:  # EmbeddingIO
                sd[f"input_modules.{m.group(1)}.0.weight"] = np.asarray(core["Embed_0"]["embedding"])
            else:  # a dense input (LinearIO, ChunkedLinearIO)
                _dense_from_jax(core["Dense_0"], f"input_modules.{m.group(1)}.0", sd)
            continue
        m = re.fullmatch(r"layer(\d+)", name)
        if m:
            for sub, p in node.items():
                for pattern, path, is_conv in _WN_LAYER:
                    mm = re.fullmatch(pattern, sub)
                    if mm:
                        base = f"layers.{m.group(1)}.{path.format(*mm.groups())}"
                        k = np.asarray(p["kernel"])
                        sd[f"{base}.weight"] = _conv_t(k) if is_conv else k.T
                        if "bias" in p:
                            sd[f"{base}.bias"] = np.asarray(p["bias"])
                        break
                else:
                    raise ValueError(f"unmapped WaveNet layer parameter {name}/{sub}")
            continue
        m = re.fullmatch(r"output_modules_(\d+)", name)
        if m and "estimator" not in node:  # a dense head (LinearIO, ChunkedLinearIO)
            _dense_from_jax(node["core"]["Dense_0"], f"output_modules.{m.group(1)}.0", sd)
            continue
        if m:
            for dname, d in node["estimator"]["core"].items():
                k = int(dname.split("_")[1])
                base = f"output_modules.{m.group(1)}.estimator.0.fc.{2 * k}"
                sd[f"{base}.weight"] = np.asarray(d["kernel"]).T
                sd[f"{base}.bias"] = np.asarray(d["bias"])
            continue
        raise ValueError(f"unmapped WaveNet parameter {name}")
    return _to_torch(sd)


def wavenet_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``WaveNet`` state_dict -> the JAX WaveNet parameter tree
    (nested dicts of f32 numpy arrays)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}
    layer_paths = [
        (re.compile(r"layers\.(\d+)\.conv_dil\.(\d+)\.0\.(weight|bias)"), "conv_dil{}", True),
        (re.compile(r"layers\.(\d+)\.conv_1x1\.(\d+)\.0\.(weight|bias)"), "conv_1x1_{}", True),
        (re.compile(r"layers\.(\d+)\.conv_(skip|res)\.(weight|bias)"), "conv_{}", True),
        (re.compile(r"layers\.(\d+)\.aff_res()\.(weight|bias)"), "aff_res", False),
    ]
    for key, v in sd.items():
        m = re.fullmatch(r"input_modules\.(\d+)\.0\.weight", key)
        if m and v.ndim == 2 and f"input_modules.{m.group(1)}.0.bias" not in sd:
            _put(tree, f"input_modules_{m.group(1)}/core/Embed_0/embedding", v)
            continue
        m = re.fullmatch(r"(input|output)_modules\.(\d+)\.0\.(weight|bias)", key)
        if m:
            _dense_to_jax(tree, f"{m.group(1)}_modules_{m.group(2)}/core/Dense_0", m.group(3), v)
            continue
        for pattern, sub, is_conv in layer_paths:
            m = pattern.fullmatch(key)
            if m:
                i, d, what = m.groups()
                base = f"layer{i}/{sub.format(d)}"
                if what == "bias":
                    _put(tree, f"{base}/bias", v)
                else:
                    _put(tree, f"{base}/kernel", _conv_t(v) if is_conv else v.T)
                break
        else:
            m = re.fullmatch(r"output_modules\.(\d+)\.estimator\.0\.fc\.(\d+)\.(weight|bias)", key)
            if not m:
                raise ValueError(f"unmapped WaveNet state_dict entry {key}")
            j, k, what = m.groups()
            base = f"output_modules_{j}/estimator/core/Dense_{int(k) // 2}"
            _put(tree, f"{base}/{'kernel' if what == 'weight' else 'bias'}",
                 v.T if what == "weight" else v)
    return tree


# SimpleTransformer attention: flax submodule -> torch's attention module name
_ATTN = {"self_attn": "self_attn", "cross_attn": "multihead_attn"}
_FLAX_ATTN = {v: k for k, v in _ATTN.items()}
_QKV = ("query", "key", "value")


def _stack_from_jax(node: Mapping, base: str, sd: Dict[str, np.ndarray]) -> None:
    """A flax ``DecoderStack``'s params (``block{l}``, ``final_ln``) -> the
    port's ``{base}.layers.{l}.*`` and ``{base}.norm.*``."""
    for blk, p in node.items():
        if blk == "final_ln":
            sd[f"{base}.norm.weight"] = np.asarray(p["scale"])
            sd[f"{base}.norm.bias"] = np.asarray(p["bias"])
            continue
        m = re.fullmatch(r"block(\d+)", blk)
        if not m:
            raise ValueError(f"unmapped transformer parameter {base}/{blk}")
        layer = f"{base}.layers.{m.group(1)}"
        for sub, q in p.items():
            if sub in _ATTN:
                a = f"{layer}.{_ATTN[sub]}"
                d = np.asarray(q["out"]["kernel"]).shape[-1]
                sd[f"{a}.in_proj_weight"] = np.concatenate(
                    [np.asarray(q[k]["kernel"]).reshape(d, d).T for k in _QKV])
                sd[f"{a}.in_proj_bias"] = np.concatenate(
                    [np.asarray(q[k]["bias"]).reshape(d) for k in _QKV])
                sd[f"{a}.out_proj.weight"] = np.asarray(q["out"]["kernel"]).reshape(d, d).T
                sd[f"{a}.out_proj.bias"] = np.asarray(q["out"]["bias"])
            elif re.fullmatch(r"ln[123]", sub):
                sd[f"{layer}.norm{sub[2]}.weight"] = np.asarray(q["scale"])
                sd[f"{layer}.norm{sub[2]}.bias"] = np.asarray(q["bias"])
            elif re.fullmatch(r"Dense_[01]", sub):
                k = int(sub[-1]) + 1
                sd[f"{layer}.linear{k}.weight"] = np.asarray(q["kernel"]).T
                sd[f"{layer}.linear{k}.bias"] = np.asarray(q["bias"])
            else:
                raise ValueError(f"unmapped transformer parameter {base}/{blk}/{sub}")


def _head_from_jax(node: Mapping, j: str, sd: Dict[str, np.ndarray]) -> None:
    """An MLP head's ``estimator/core/Dense_{k}`` -> ``output_modules.{j}.estimator.0.fc.{2k}``."""
    for dname, d_ in node["estimator"]["core"].items():
        base = f"output_modules.{j}.estimator.0.fc.{2 * int(dname.split('_')[1])}"
        sd[f"{base}.weight"] = np.asarray(d_["kernel"]).T
        sd[f"{base}.bias"] = np.asarray(d_["bias"])


def transformer_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SimpleTransformer params -> the port's ``SimpleTransformer``
    state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"input_heads_(\d+)", name)
        if m:
            sd[f"input_module.heads.{m.group(1)}.0.weight"] = np.asarray(
                node["core"]["Embed_0"]["embedding"])
            continue
        if name == "model":
            _stack_from_jax(node, "model", sd)
            continue
        m = re.fullmatch(r"output_modules_(\d+)", name)
        if m:
            _head_from_jax(node, m.group(1), sd)
            continue
        raise ValueError(f"unmapped SimpleTransformer parameter {name}")
    return _to_torch(sd)


def _stack_key_to_jax(tree: Dict, key: str, v: np.ndarray, base: str, flax_base: str,
                      n_heads: int) -> bool:
    """Map one ``{base}.layers.{l}.*`` or ``{base}.norm.*`` entry of a
    decoder stack onto the flax tree under ``flax_base``; False when ``key``
    is not one."""
    b = re.escape(base)
    m = re.fullmatch(rf"{b}\.norm\.(weight|bias)", key)
    if m:
        _put(tree, f"{flax_base}/final_ln/{'scale' if m.group(1) == 'weight' else 'bias'}", v)
        return True
    m = re.fullmatch(rf"{b}\.layers\.(\d+)\.(self_attn|multihead_attn)\.(.+)", key)
    if m:
        i, attn, what = m.groups()
        blk = f"{flax_base}/block{i}/{_FLAX_ATTN[attn]}"
        d = v.shape[-1]
        if what == "in_proj_weight":
            for k, w in zip(_QKV, np.split(v, 3)):
                _put(tree, f"{blk}/{k}/kernel", w.T.reshape(d, n_heads, d // n_heads))
        elif what == "in_proj_bias":
            d = v.shape[0] // 3
            for k, b_ in zip(_QKV, np.split(v, 3)):
                _put(tree, f"{blk}/{k}/bias", b_.reshape(n_heads, d // n_heads))
        elif what == "out_proj.weight":
            _put(tree, f"{blk}/out/kernel", v.T.reshape(n_heads, d // n_heads, d))
        elif what == "out_proj.bias":
            _put(tree, f"{blk}/out/bias", v)
        else:
            raise ValueError(f"unmapped transformer state_dict entry {key}")
        return True
    m = re.fullmatch(rf"{b}\.layers\.(\d+)\.norm([123])\.(weight|bias)", key)
    if m:
        i, k, what = m.groups()
        _put(tree, f"{flax_base}/block{i}/ln{k}/{'scale' if what == 'weight' else 'bias'}", v)
        return True
    m = re.fullmatch(rf"{b}\.layers\.(\d+)\.linear([12])\.(weight|bias)", key)
    if m:
        i, k, what = m.groups()
        _put(tree, f"{flax_base}/block{i}/Dense_{int(k) - 1}/"
                   f"{'kernel' if what == 'weight' else 'bias'}", v.T if what == "weight" else v)
        return True
    return False


def _head_key_to_jax(tree: Dict, key: str, v: np.ndarray) -> bool:
    """Map one ``output_modules.{j}.estimator.0.fc.{2k}`` entry; False when
    ``key`` is not one."""
    m = re.fullmatch(r"output_modules\.(\d+)\.estimator\.0\.fc\.(\d+)\.(weight|bias)", key)
    if not m:
        return False
    j, k, what = m.groups()
    base = f"output_modules_{j}/estimator/core/Dense_{int(k) // 2}"
    _put(tree, f"{base}/{'kernel' if what == 'weight' else 'bias'}", v.T if what == "weight" else v)
    return True


def transformer_params_to_jax(state_dict: Mapping[str, torch.Tensor], n_heads: int) -> Dict:
    """The port's ``SimpleTransformer`` state_dict -> the JAX SimpleTransformer
    parameter tree (nested dicts of f32 numpy arrays).  A state_dict does not
    hold the head count flax's (d, nH, dH) kernels need: ``n_heads`` gives it
    (the net's ``config.n_heads``)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}
    for key, v in sd.items():
        m = re.fullmatch(r"input_module\.heads\.(\d+)\.0\.weight", key)
        if m:
            _put(tree, f"input_heads_{m.group(1)}/core/Embed_0/embedding", v)
            continue
        if _stack_key_to_jax(tree, key, v, "model", "model", n_heads):
            continue
        if not _head_key_to_jax(tree, key, v):
            raise ValueError(f"unmapped SimpleTransformer state_dict entry {key}")
    return tree


def jukebox_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX JukeBox params -> the port's ``JukeBox`` state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"tiers_(\d+)", name)
        if m:
            base = f"tiers.{m.group(1)}"
            for sub, p in node.items():
                if sub == "model":
                    _stack_from_jax(p, f"{base}.model", sd)
                elif sub == "up_sampler":
                    sd[f"{base}.up_sampler.fc.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
                    sd[f"{base}.up_sampler.fc.bias"] = np.asarray(p["Dense_0"]["bias"])
                elif sub == "input_module":
                    for head, h in p.items():
                        j = re.fullmatch(r"heads_(\d+)", head).group(1)
                        core, pre = h["core"], f"{base}.input_module.heads.{j}.2"
                        if "Dense_0" in core:
                            sd[f"{pre}.weight"] = np.asarray(core["Dense_0"]["kernel"]).T
                            sd[f"{pre}.bias"] = np.asarray(core["Dense_0"]["bias"])
                        else:  # the bottom's framed conv: (k, out) -> (out, 1, k)
                            d_ = core["Conv1dResampler_0"]["Dense_0"]
                            sd[f"{pre}.2.cv.weight"] = np.asarray(d_["kernel"]).T[:, None, :]
                            sd[f"{pre}.2.cv.bias"] = np.asarray(d_["bias"])
                else:
                    raise ValueError(f"unmapped JukeBox parameter {name}/{sub}")
            continue
        m = re.fullmatch(r"output_modules_(\d+)", name)
        if not m:
            raise ValueError(f"unmapped JukeBox parameter {name}")
        _head_from_jax(node, m.group(1), sd)
    return _to_torch(sd)


def jukebox_params_to_jax(state_dict: Mapping[str, torch.Tensor], n_heads: int) -> Dict:
    """The port's ``JukeBox`` state_dict -> the JAX JukeBox parameter tree
    (nested dicts of f32 numpy arrays); ``n_heads`` as for
    :func:`transformer_params_to_jax`."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}
    for key, v in sd.items():
        m = re.fullmatch(r"tiers\.(\d+)\.(.+)", key)
        if m:
            i, rest = m.groups()
            if _stack_key_to_jax(tree, key, v, f"tiers.{i}.model", f"tiers_{i}/model", n_heads):
                continue
            mm = re.fullmatch(r"up_sampler\.fc\.(weight|bias)", rest)
            if mm:
                what = mm.group(1)
                _put(tree, f"tiers_{i}/up_sampler/Dense_0/{'kernel' if what == 'weight' else 'bias'}",
                     v.T if what == "weight" else v)
                continue
            mm = re.fullmatch(r"input_module\.heads\.(\d+)\.2\.(weight|bias)", rest)
            if mm:
                j, what = mm.groups()
                _put(tree, f"tiers_{i}/input_module/heads_{j}/core/Dense_0/"
                           f"{'kernel' if what == 'weight' else 'bias'}",
                     v.T if what == "weight" else v)
                continue
            mm = re.fullmatch(r"input_module\.heads\.(\d+)\.2\.2\.cv\.(weight|bias)", rest)
            if mm:
                j, what = mm.groups()
                base = f"tiers_{i}/input_module/heads_{j}/core/Conv1dResampler_0/Dense_0"
                if what == "weight":  # (out, 1, k) -> (k, out)
                    _put(tree, f"{base}/kernel", v[:, 0, :].T)
                else:
                    _put(tree, f"{base}/bias", v)
                continue
        if not _head_key_to_jax(tree, key, v):
            raise ValueError(f"unmapped JukeBox state_dict entry {key}")
    return tree


_GATES = "ifgo"  # torch's packed LSTM gate order


def _cell_from_jax(cell: Mapping, base: str, sfx: str, sd: Dict[str, np.ndarray]) -> None:
    """A flax ``OptimizedLSTMCell``'s per-gate kernels and hidden biases ->
    ``{base}.weight_ih_l0{sfx}`` (4H, D), ``weight_hh_l0{sfx}`` (4H, H),
    ``bias_hh_l0{sfx}`` (4H,) and a zero ``bias_ih_l0{sfx}``."""
    sd[f"{base}.weight_ih_l0{sfx}"] = np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES])
    sd[f"{base}.weight_hh_l0{sfx}"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES])
    sd[f"{base}.bias_hh_l0{sfx}"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
    sd[f"{base}.bias_ih_l0{sfx}"] = np.zeros_like(sd[f"{base}.bias_hh_l0{sfx}"])


def seq2seq_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``Seq2SeqLSTMNetwork`` params -> the port's state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name in ("enc", "dec"):
            for sub, p in node.items():
                m = re.fullmatch(r"lstm(\d+)", sub)
                if m:
                    for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
                        _cell_from_jax(p[direction]["l0"], f"{name}.lstm.{m.group(1)}", sfx, sd)
                elif sub == "fc_out":
                    sd["enc.fc_out.weight"] = np.asarray(p["kernel"]).T
                elif sub == "fc":
                    _dense_from_jax(p["Dense_0"], f"{name}.fc.fc", sd)
                else:
                    raise ValueError(f"unmapped Seq2Seq parameter {name}/{sub}")
            continue
        m = re.fullmatch(r"output_heads_(\d+)", name)
        if m and "Dense_0" in node.get("core", {}):
            _dense_from_jax(node["core"]["Dense_0"], f"output_module.heads.{m.group(1)}.0", sd)
            continue
        if name == "input_module":
            for head, p in node.items():
                j = re.fullmatch(r"heads_(\d+)", head).group(1)
                core = p["core"]
                if "Embed_0" in core:
                    sd[f"input_module.heads.{j}.0.weight"] = np.asarray(core["Embed_0"]["embedding"])
                else:
                    _dense_from_jax(core["Dense_0"], f"input_module.heads.{j}.0", sd)
            continue
        raise ValueError(f"unmapped Seq2Seq parameter {name}")
    return _to_torch(sd)


def seq2seq_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``Seq2SeqLSTMNetwork`` state_dict -> the JAX parameter tree
    (nested dicts of f32 numpy arrays), the LSTM cells' one bias
    ``bias_hh + bias_ih``."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}
    for key, v in sd.items():
        m = re.fullmatch(r"(enc|dec)\.lstm\.(\d+)\.(weight|bias)_(ih|hh)_l0(_reverse)?", key)
        if m:
            side, n, kind, which, rev = m.groups()
            base = f"{side}/lstm{n}/{'bwd' if rev else 'fwd'}/l0"
            if kind == "bias":
                if which == "hh":
                    b = v + sd[key.replace("bias_hh", "bias_ih")]
                    for g, chunk in zip(_GATES, np.split(b, 4)):
                        _put(tree, f"{base}/h{g}/bias", chunk)
                continue
            for g, chunk in zip(_GATES, np.split(v, 4, axis=0)):
                _put(tree, f"{base}/{'i' if which == 'ih' else 'h'}{g}/kernel", chunk.T)
            continue
        if key == "enc.fc_out.weight":
            _put(tree, "enc/fc_out/kernel", v.T)
            continue
        m = re.fullmatch(r"(enc|dec)\.fc\.fc\.(weight|bias)", key)
        if m:
            _dense_to_jax(tree, f"{m.group(1)}/fc/Dense_0", m.group(2), v)
            continue
        m = re.fullmatch(r"output_module\.heads\.(\d+)\.0\.(weight|bias)", key)
        if m:
            _dense_to_jax(tree, f"output_heads_{m.group(1)}/core/Dense_0", m.group(2), v)
            continue
        m = re.fullmatch(r"input_module\.heads\.(\d+)\.0\.(weight|bias)", key)
        if m:
            j, what = m.groups()
            if what == "weight" and f"input_module.heads.{j}.0.bias" not in sd:
                _put(tree, f"input_module/heads_{j}/core/Embed_0/embedding", v)
            else:
                _dense_to_jax(tree, f"input_module/heads_{j}/core/Dense_0", what, v)
            continue
        raise ValueError(f"unmapped Seq2Seq state_dict entry {key}")
    return tree


def tiedae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``TiedAE`` params -> the port's state_dict (CPU f32)."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"w(\d+)", name)
        if m:
            sd[f"kernels.{m.group(1)}"] = _conv_t(node)
            continue
        m = re.fullmatch(r"(input|output)_modules_(\d+)", name)
        if m:
            base = f"{m.group(1)}_modules.{m.group(2)}.0"
            core = node["core"]
            if "Embed_0" in core:
                sd[f"{base}.weight"] = np.asarray(core["Embed_0"]["embedding"])
            else:
                _dense_from_jax(core["Dense_0"], base, sd)
            continue
        raise ValueError(f"unmapped TiedAE parameter {name}")
    return _to_torch(sd)


def tiedae_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's ``TiedAE`` state_dict -> the JAX parameter tree (nested
    dicts of f32 numpy arrays)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree: Dict = {}
    for key, v in sd.items():
        m = re.fullmatch(r"kernels\.(\d+)", key)
        if m:
            _put(tree, f"w{m.group(1)}", _conv_t(v))
            continue
        m = re.fullmatch(r"(input|output)_modules\.(\d+)\.0\.(weight|bias)", key)
        if m:
            side, j, what = m.groups()
            path = f"{side}_modules_{j}/core"
            if what == "weight" and f"{side}_modules.{j}.0.bias" not in sd:
                _put(tree, f"{path}/Embed_0/embedding", v)
            else:
                _dense_to_jax(tree, f"{path}/Dense_0", what, v)
            continue
        raise ValueError(f"unmapped TiedAE state_dict entry {key}")
    return tree
