"""The port's boundaries: what it imports, where it runs, and the card test.

* ``mimikit_tpu_torch`` imports torch and never jax nor ``mimikit_tpu``;
  ``chip_smoke.py`` neither (checked in a fresh process and by a source scan
  of every module, the spectral path's and the ensemble and autoencoder
  modules among them); the ensemble and autoencoder names are in ``mmk``;
* its entry points run on the card unless the caller asks for the CPU, and a
  CUDA request on a machine without CUDA raises instead of running on the
  CPU;
* on CPU tensors every kernel wrapper runs its plain twin and counts no
  launch (the tier-pyramid decode leaves its advanced window in place);
* ``precision.py``: the compute-dtype context, the casts, the dtype names;
* on a machine with a card, ``chip_smoke.py --quick`` builds the kernels
  and holds them against their plain twins (marked ``cuda``; skipped
  without a card).

Every torch import happens in a subprocess: this test process has jax.
"""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mimikit_tpu_torch")


def _python(code: str, timeout: int = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b"
    r"|import\s+mimikit_tpu(?!_torch)\b|from\s+mimikit_tpu(?!_torch)\b)",
    re.M,
)


_CUDA_CALLS = [
    "mmk.default_device()",
    "mmk.SampleRNN.from_config(cfg)",
    "mmk.SampleRNN.from_config(cfg, device='cuda')",
    "net.generate((torch.zeros(2, 16, dtype=torch.int32, device='cuda'),), 4)",
    "sd._launch(pack, p, st, 8, 4, torch.empty(2, 4, dtype=torch.int32), 16, 0, None)",
    "sd._launch(pack16, p, st, 8, 4, torch.empty(2, 4, dtype=torch.int32), 16, 0, None)",
    "fl.fused_lstm_layer(*(a.to('cuda') for a in L))",
    "mmk.WaveNet.from_config(wcfg)",
    "mmk.WaveNet.from_config(wcfg, device='cuda')",
    "wd._launch(wpack, wp, wst, 1, 4, torch.empty(2, 4, dtype=torch.int32), 1, 0, None)",
    "cat.categorical(torch.zeros(2, 8, device='cuda'), 1.0, 0)",
    "mmk.SimpleTransformer.from_config(tcfg)",
    "mmk.SimpleTransformer.from_config(tcfg, device='cuda')",
    "td._launch(tpack, torch.zeros(1, 16, dtype=torch.int32), 4, 16, 0, None)",
    "td.decode_window(tpack, torch.zeros(1, 16, dtype=torch.int32, device='cuda'), 4, 0, None)",
    "tk.decode_chunk(tpack, torch.zeros(16, 2, dtype=torch.int32, device='cuda'), tst, 1, 4, None, 0)",
    "tk.decode_chunk(tpack16, torch.zeros(16, 2, dtype=torch.int32, device='cuda'), tst, 1, 4, None, 0)",
    "mmk.JukeBox.from_config(jcfg)",
    "mmk.JukeBox.from_config(jcfg, device='cuda')",
    "jbd._launch(jpack, torch.zeros(1, 16, dtype=torch.int32), 16, 4, 0, None)",
    "jbd.decode_pyramid(jpack, torch.zeros(1, 16, dtype=torch.int32, device='cuda'), 16, 4, 0, None)",
    "mu.mulaw_compress(torch.zeros(8, device='cuda'))",
    "mu.mulaw_expand(torch.zeros(8, dtype=torch.int32, device='cuda'))",
    "mmk.Seq2SeqLSTMNetwork.from_config(scfg)",
    "mmk.Seq2SeqLSTMNetwork.from_config(scfg, device='cuda')",
    "mmk.TiedAE.from_config(acfg)",
    "mmk.TiedAE.from_config(acfg, device='cuda')",
]
# the spectral path's modules, which the source scan must reach
SPECTRAL = ("features/dsp.py", "features/functionals.py", "modules/io.py", "modules/misc.py",
            "modules/loss_functions.py", "modules/rnn.py", "networks/s2s_lstm.py",
            "networks/wavenet.py", "io_spec.py", "weights.py", "checkpoint.py",
            "loops/generate.py", "demos/seq2seq.py", "demos/freqnet.py")
# the ensemble and autoencoder modules, which the source scan must reach too
MODELS = ("models/ensemble_generator.py", "models/nnn.py", "models/patterns.py",
          "extract/segment.py", "extract/from_neighbors.py", "networks/tied_autoencoder.py",
          "loops/beta_scheduler.py", "modules/threefry.py", "demos/ensemble_generator.py",
          "demos/checkpoint_k_bests.py")
# the names the ensemble and autoencoder slice adds to the flat namespace
SLICE_NAMES = ("EnsembleGenerator", "Event", "VotingEnsemble", "NearestNextNeighbor", "Pbind",
               "Pseq", "Pwhite", "Prand", "Pattern", "inf", "Resample", "MelSpec", "MFCC",
               "Chroma", "get_metadata", "TiedAE", "AutoEncoder", "EncodeDecodeLoop",
               "beta_schedule", "adam_with_beta_schedule", "BetaScheduledAdam",
               "nearest_neighbor", "cum_entropy", "repeat_rate", "frame", "dtw",
               "optimal_path", "WeightedL1", "DiffOverTime", "DistanceOverTime", "MaximizeStd",
               "MaximizeMagnitude", "ScaledOutputsL1", "Mean2dDiff", "CosineSimilarity",
               "AngularDistance", "ElementWiseAngularDistance", "tiedae_state_dict_from_jax",
               "tiedae_params_to_jax")

_PROBE = """
import json, sys
import torch, mimikit_tpu_torch as mmk
from mimikit_tpu_torch.ops import categorical as cat
from mimikit_tpu_torch.ops import fused_lstm as fl
from mimikit_tpu_torch.ops import jukebox_decode as jbd
from mimikit_tpu_torch.ops import mulaw as mu
from mimikit_tpu_torch.ops import samplernn_decode as sd
from mimikit_tpu_torch.ops import transformer_decode as td
from mimikit_tpu_torch.ops import transformer_kv as tk
from mimikit_tpu_torch.ops import wavenet_decode as wd
res = {"cuda": torch.cuda.is_available()}
res["foreign"] = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "mimikit_tpu")]
io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16))
cfg = mmk.SampleRNN.Config(frame_sizes=(8, 4, 2), hidden_dim=16, io_spec=io)
net = mmk.SampleRNN.from_config(cfg, device="cpu")
pack = sd.samplernn_weight_pack(net)
pack16 = sd.samplernn_weight_pack(net, torch.bfloat16)
p = torch.zeros(2, 16, dtype=torch.int32)
st = sd.init_decode_state(net, p)
L = [torch.randn(3, 2, 8), torch.randn(8, 32), torch.randn(8, 32), torch.randn(32),
     torch.zeros(2, 8), torch.zeros(2, 8)]
wio = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16,
                                                   input_module_type="embedding"))
wcfg = mmk.WaveNet.Config(io_spec=wio, blocks=(3,), dims_dilated=(16,), skips_dim=16)
wpack = wd.wavenet_weight_pack(mmk.WaveNet.from_config(wcfg, device="cpu"))
wp = torch.zeros(2, 9, dtype=torch.int32)
wst = wd.init_decode_state(wpack, wp)
tcfg = mmk.SimpleTransformer.Config(io_spec=wio, model_dim=16, n_heads=2, feedforward_dim=32,
                                    num_layers=2, rf=16)
tpack = td.transformer_weight_pack(mmk.SimpleTransformer.from_config(tcfg, device="cpu"))
tpack16 = td.transformer_weight_pack(mmk.SimpleTransformer.from_config(tcfg, device="cpu"),
                                     torch.bfloat16)
tp = torch.zeros(2, 16, dtype=torch.int32)
tst = tk.init_kv_state(tpack, tp)
jcfg = mmk.JukeBox.Config(io_spec=io, frame_sizes=(8, 4, 2), model_dim=16, n_heads=2,
                          feedforward_dim=32, num_layers=1, rf=16)
jpack = jbd.jukebox_weight_pack(mmk.JukeBox.from_config(jcfg, device="cpu"))
sio = mmk.IOSpec.magspec_io(mmk.IOSpec.MagSpecIOConfig(sr=16000, n_fft=64, hop_length=16))
scfg = mmk.Seq2SeqLSTMNetwork.Config(io_spec=sio, model_dim=16, hop=4)
acfg = mmk.TiedAE.Config(io_spec=sio, kernel_sizes=(3,), dims=(8,))
res["missing"] = [n for n in SLICE_NAMES if not hasattr(mmk, n)]
res["demos"] = [hasattr(mmk.demos, d) for d in ("ensemble_generator", "checkpoint_k_bests")]
for call in CALLS:
    try:
        eval(call)
        res[call] = "ran"
    except (RuntimeError, AssertionError, ValueError) as e:
        res[call] = "raised " + type(e).__name__
out = sd.decode_chunk(pack, p, st, 8, 4, 0, None)
res["cpu_chunk"] = [list(out.shape), sd.decode_chunk.launches, sd.decode_single.launches]
h_all, h_T, c_T = fl.fused_lstm_layer(*(a.requires_grad_() for a in L))
(h_all.sum() + c_T.sum()).backward()
res["cpu_lstm"] = [list(h_all.shape), fl.lstm_forward.launches, fl.lstm_backward.launches,
                   all(a.grad is not None for a in L)]
out = wd.decode_chunk(wpack, wp, wst, 1, 4, 0, None)
res["cpu_wn_chunk"] = [list(out.shape), wd.decode_chunk.launches, wd.decode_single.launches]
out = cat.categorical(torch.randn(2, 8), 0.9, 0)
res["cpu_cat"] = [list(out.shape), cat.categorical.launches]
out = td.decode_window(tpack, tp, 4, 0, None)
res["cpu_tf_window"] = [list(out.shape), td.decode_window.launches]
out = tk.decode_chunk(tpack, tp.t().contiguous(), tst, 1, 20, 0.9, 0)
res["cpu_tf_chunk"] = [list(out.shape), tk.decode_chunk.launches]
win = torch.zeros(2, 16, dtype=torch.int32)
out = jbd.decode_pyramid(jpack, win, 16, 5, 0, 0.9)
res["cpu_jb"] = [list(out.shape), jbd.decode_pyramid.launches, bool((win[:, -1] == 0).all()),
                 win[:, -6:-1].tolist() == out.tolist()]
out = mu.mulaw_expand(mu.mulaw_compress(torch.linspace(-1, 1, 9)))
res["cpu_mulaw"] = [list(out.shape), mu.mulaw_compress.launches, mu.mulaw_expand.launches]
from mimikit_tpu_torch import precision as prec
lin = mmk.Linearizer(32)
toks = torch.arange(32)
outside = lin(toks)
with prec.compute(torch.bfloat16):
    inside = [str(prec.compute_dtype()), str(lin(toks).dtype),
              bool((lin(toks).float() == outside).all())]
copy16 = prec.cast_floats(net, torch.bfloat16)
tree = prec.cast_floats({"w": torch.ones(2), "i": torch.arange(2), "n": 3}, torch.bfloat16)
res["precision"] = {
    "default": str(prec.compute_dtype()), "inside": inside, "after": str(prec.compute_dtype()),
    "linearizer": str(outside.dtype),
    "copy": sorted({str(t.dtype) for t in copy16.parameters()}),
    "original": sorted({str(t.dtype) for t in net.parameters()}),
    "tree": [str(tree["w"].dtype), str(tree["i"].dtype), tree["n"]],
    "resolve": [str(prec.resolve_dtype(n)) for n in ("bf16", "bfloat16", "float32", None,
                                                      torch.float16, torch.float32)],
    "packs": [str(pack16.flat.dtype), str(tpack16.flat.dtype), str(tpack16.pe_window.dtype)],
}
try:
    prec.resolve_dtype("int8")
    res["precision"]["bad"] = "accepted"
except ValueError:
    res["precision"]["bad"] = "raised"
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def probe():
    """One fresh process: what importing the port loads, and how each call
    behaves on this machine."""
    res = _python(f"CALLS = {_CUDA_CALLS!r}\nSLICE_NAMES = {SLICE_NAMES!r}\n" + _PROBE)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_fresh_import_loads_neither_jax_nor_the_jax_package(probe):
    assert probe["foreign"] == []


@pytest.mark.parametrize("rel", SPECTRAL)
def test_source_scan_reaches_the_spectral_modules(rel):
    assert os.path.join(PKG, rel) in _sources()


@pytest.mark.parametrize("rel", MODELS)
def test_source_scan_reaches_the_ensemble_and_autoencoder_modules(rel):
    assert os.path.join(PKG, rel) in _sources()


def test_slice_names_in_the_flat_namespace(probe):
    """The ensemble and autoencoder slice's classes and functions are
    ``mmk.<Name>``, and its two demos are ``mmk.demos`` modules."""
    assert probe["missing"] == []
    assert probe["demos"] == [True, True]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, hits


@pytest.mark.parametrize("call", _CUDA_CALLS)
def test_cuda_request_without_cuda_raises(probe, call):
    """No card here: asking for CUDA raises (the kernel launcher refuses a
    CPU tensor); nothing runs on the CPU instead."""
    if probe["cuda"]:
        pytest.skip("a CUDA device is present")
    assert probe[call].startswith("raised"), probe[call]


def test_cpu_tensors_take_the_plain_twin(probe):
    """The wrappers choose the plain twin by the tensor's device: on CPU
    tensors they return tokens and count no kernel launch."""
    assert probe["cpu_chunk"] == [[2, 4], 0, 0]


def test_cpu_tensors_take_the_plain_lstm(probe):
    """The fused LSTM layer on CPU tensors runs its plain versions, forward
    and backward, and counts no kernel launch."""
    assert probe["cpu_lstm"] == [[3, 2, 8], 0, 0, True]


def test_cpu_tensors_take_the_plain_wavenet_decode(probe):
    """The WaveNet decode wrappers on CPU tensors run the plain twin and
    count no kernel launch."""
    assert probe["cpu_wn_chunk"] == [[2, 4], 0, 0]


def test_cpu_tensors_take_the_plain_categorical(probe):
    """The categorical sampler on a CPU tensor runs its plain twin and
    counts no kernel launch."""
    assert probe["cpu_cat"] == [[2], 0]


def test_cpu_tensors_take_the_plain_transformer_decodes(probe):
    """The transformer decode wrappers (window, K6; KV ring, K7) on CPU
    tensors run their plain twins and count no kernel launch."""
    assert probe["cpu_tf_window"] == [[2, 4], 0]
    assert probe["cpu_tf_chunk"] == [[2, 20], 0]


def test_cpu_tensors_take_the_plain_pyramid_decode(probe):
    """The tier-pyramid decode wrapper on CPU tensors runs the plain twin,
    counts no kernel launch and leaves the advanced window in place: the
    tokens in the slots before the placeholder, the placeholder zero."""
    assert probe["cpu_jb"] == [[2, 5], 0, True, True]


def test_cpu_tensors_take_the_plain_mulaw(probe):
    assert probe["cpu_mulaw"] == [[9], 0, 0]


def test_precision_policy(probe):
    """precision.py: the compute dtype is f32 outside a policy and bf16
    inside ``compute(bfloat16)`` (the class-index linearizer follows it,
    exactly: the mu-law classes are bf16 values); ``cast_floats`` copies a
    module (the original stays f32) or a dict (ints pass); ``resolve_dtype``
    maps the trainer's names; the weight packs take bf16, the PE rows stay
    f32."""
    got = probe["precision"]
    assert got["default"] == got["after"] == got["linearizer"] == "torch.float32"
    assert got["inside"] == ["torch.bfloat16", "torch.bfloat16", True]
    assert got["copy"] == ["torch.bfloat16"] and got["original"] == ["torch.float32"]
    assert got["tree"] == ["torch.bfloat16", "torch.int64", 3]
    assert got["resolve"] == ["torch.bfloat16", "torch.bfloat16", "None", "None",
                              "torch.float16", "None"]
    assert got["bad"] == "raised"
    assert got["packs"] == ["torch.bfloat16", "torch.bfloat16", "torch.float32"]


@pytest.mark.cuda
def test_decode_kernel_matches_plain_twin_on_card():
    probe = _python("import torch; print(torch.cuda.is_available())")
    if probe.stdout.strip() != "True":
        pytest.skip("needs a CUDA device and nvcc (run on the card: python3 chip_smoke.py)")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--quick"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
