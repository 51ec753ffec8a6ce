"""The port's bf16 decode routes against the JAX package's, on the CPU.

``MMK_PALLAS_BF16=1`` packs SampleRNN's decode weights in bfloat16 (K1/K2's
``weight_dtype="bf16"``); ``MMK_DECODE_BF16=1`` runs the transformer KV
stream on K7's bf16 weights and the window re-feed in bf16.  On the CPU the
kernels' wrappers run their bf16 plain twins, so this holds the twins — the
arithmetic the CUDA kernels are checked against on the card — and the bf16
window route to JAX's bf16 kernels (interpret mode, forced with
``MMK_PALLAS_DECODE=1``) and JAX's bf16 window decoder:

* teacher forcing: JAX's tokens fed to the port's bf16 twin; every JAX token
  must score within ``TOL`` = 1e-4 * max|score| of its row's maximum.  The
  two sides round the same values to bf16 and sum in other orders; over
  every row of these cases the gap measured 0.  JAX runs with XLA's excess
  precision off (``XLA_PER_OP``), so every bf16 op of its program rounds, as
  flax's bf16 ops and K1/K7's ``.astype(bf16)`` dot inputs ask; with it on,
  XLA keeps f32 across some ops of a fusion, the places depending on the
  shapes, and the gaps grow past 1e-2;
* free running: the port's tokens equal JAX's up to the first near-tie (a
  row whose top two scores lie within ``TOL``);
* the control: a twin that leaves the products' inputs in f32 (the bf16
  weights unchanged) must fail one of the two checks above: its scores move
  by about 3e-3 of a row's scale, and in these cases it picks other tokens
  than JAX at a few rows (the SampleRNN cases at B=32 and 64, and the KV
  stream at 32 streams x 140 tokens, are sized for that);
* routes: SampleRNN's generate at B=2 and 32 takes decode_single and at B=64
  decode_chunk, with a bf16 pack; the KV stream takes K7 with a bf16 pack and
  two chunkings give the same tokens; the window route's bf16 copy is built
  once a generate call and once a re-feed stream; a net outside K7's bf16
  limits streams through the f32 K7 route with a warning.

JAX runs in one subprocess (this file run as a script), the port in another
(``torch_port_worker.py bf16_decode``).
"""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from tests.torch_port_harness import ROOT, flatten, run_port
from tests.test_torch_jukebox import NETS as JB_NETS, _net as _jb_net
from tests.test_torch_sample_rnn import _net as _srnn_net
from tests.test_torch_transformer import NETS as TF_NETS, _net as _tf_net

TOL = 1e-4  # a JAX token must score within TOL * max|score| of the row max
# XLA may keep f32 between the ops of a fusion where the program asks for bf16
# (excess precision); off, every bf16 op rounds, as flax and K1/K7's dots ask
XLA_PER_OP = "--xla_allow_excess_precision=false"
Q, N_STEPS = 32, 40
SRNN_FS = (8, 4, 2)
WIDE_B = 33  # one stream more than SimpleTransformer._K6_MAX_BATCH
# the KV stream's net: d 128, 4 heads (JAX's fused KV gate asks d % 128 == 0),
# as tests/test_streaming.py:448-470
KV_NET = dict(TF_NETS["d128"])
KV_B, KV_CHUNKS = 32, 20  # the KV stream: streams, and 7-token chunks of JAX's decode
# a standard net inside K7's f32 limits and outside its bf16 ones (d / n_heads = 20)
WARN_NET = dict(model_dim=40, n_heads=2)


def _tokens(it, n):
    return np.concatenate([np.asarray(c) for c in itertools.islice(it, n)], axis=1)


def _generate(net, prompt, n=N_STEPS):
    return np.asarray(net.generate((prompt,), n_steps=n, temperature=None,
                                   rng=jax.random.PRNGKey(1))[0])


def _jax_side(path: str) -> None:
    """JAX's bf16 decodes, saved to ``path`` with their inputs and weights."""
    rng = np.random.default_rng(41)
    inp = {"n_steps": np.array(N_STEPS)}
    env = os.environ
    env.pop("MMK_DECODE_KV", None)
    # SampleRNN: JAX's bf16 K1 (B=2) and K2 (B=64, and the stream) in interpret mode
    net = _srnn_net(SRNN_FS, 0)
    rf = SRNN_FS[0]
    p2 = rng.integers(0, Q, (2, 2 * rf)).astype(np.int32)
    p64 = rng.integers(0, Q, (64, 2 * rf)).astype(np.int32)
    p32 = np.random.default_rng(43).integers(0, Q, (32, 2 * rf)).astype(np.int32)
    inp.update({"srnn/yaml": np.array(net.config.serialize()), "srnn/prompt_b2": p2,
                "srnn/prompt_b32": p32, "srnn/prompt_b64": p64})
    inp.update(flatten(jax.device_get(net.params), "srnn/params/"))
    env.update(MMK_PALLAS_DECODE="1", MMK_PALLAS_BF16="1")
    assert net._pallas_weight_dtype() == "bf16"
    assert net._pallas_mode(2, p2.shape[1], N_STEPS) == "single"
    assert net._pallas_mode(32, p32.shape[1], N_STEPS) == "single"
    assert net._pallas_mode(64, p64.shape[1], N_STEPS) == "chunked"
    inp["srnn/jax_b2"] = _generate(net, p2)
    inp["srnn/jax_b32"] = _generate(net, p32)
    inp["srnn/jax_b64"] = _generate(net, p64)
    stream = _tokens(net.stream((p2,), 7, temperature=None, rng=jax.random.PRNGKey(5)),
                     N_STEPS // 7)
    inp["srnn/jax_stream"] = np.concatenate([p2, stream], 1)
    del env["MMK_PALLAS_BF16"]

    # SimpleTransformer: JAX's bf16 K7 in interpret mode, 140 tokens
    net = _tf_net(KV_NET)
    kvp = rng.integers(0, Q, (2, net.rf)).astype(np.int32)
    kvp = np.concatenate([kvp, np.random.default_rng(44).integers(0, Q, (KV_B - 2, net.rf))
                          .astype(np.int32)])
    inp.update({"kv/yaml": np.array(net.config.serialize()), "kv/prompt": kvp})
    inp.update(flatten(jax.device_get(net.params), "kv/params/"))
    env.update(MMK_DECODE_KV="1", MMK_DECODE_BF16="1")
    assert net._use_pallas_kv(KV_B, True, True)
    stream = _tokens(net.stream((kvp,), 7, temperature=None, rng=jax.random.PRNGKey(5)),
                     KV_CHUNKS)
    inp["kv/n_chunks"] = np.array(KV_CHUNKS)
    inp["kv/jax"] = np.concatenate([kvp, stream], 1)
    del env["MMK_DECODE_KV"]

    # the bf16 window decoder (MMK_PALLAS_DECODE=0: no kernel)
    env["MMK_PALLAS_DECODE"] = "0"
    net = _tf_net(TF_NETS["h4"])
    inp.update({"win_tf/yaml": np.array(net.config.serialize()),
                "win_tf/prompt": rng.integers(0, Q, (2, net.rf + 4)).astype(np.int32),
                "win_tf/prompt_wide": rng.integers(0, Q, (WIDE_B, net.rf + 4)).astype(np.int32)})
    inp.update(flatten(jax.device_get(net.params), "win_tf/params/"))
    inp["win_tf/jax_direct"] = _generate(net, inp["win_tf/prompt"])
    inp["win_tf/jax_wide"] = _generate(net, inp["win_tf/prompt_wide"])
    for tag, spec in (("jb", JB_NETS["f842"]), ("jb_out", JB_NETS["f842_fln"])):
        net = _jb_net(spec)
        prompt = rng.integers(0, Q, (2, net._window_len())).astype(np.int32)
        inp.update({f"win_{tag}/yaml": np.array(net.config.serialize()),
                    f"win_{tag}/prompt": prompt})
        inp.update(flatten(jax.device_get(net.params), f"win_{tag}/params/"))
        inp[f"win_{tag}/jax"] = _generate(net, prompt)
    net = _tf_net(WARN_NET)
    inp["warn/yaml"] = np.array(net.config.serialize())
    inp["warn/prompt"] = rng.integers(0, Q, (2, net.rf)).astype(np.int32)
    np.savez(path, **inp)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's side in a subprocess with bf16 rounded at every op (see the
    module note), then the port's."""
    tmp = str(tmp_path_factory.mktemp("bf16"))
    path = os.path.join(tmp, "jax.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + XLA_PER_OP).strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__), path], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(path, allow_pickle=False) as f:
        inp = dict(f)
    return inp, run_port("bf16_decode", inp, tmp)


def _teacher_forcing(scores, jax_tokens, first):
    """(largest gap of a JAX token below its row's max, in units of the row's
    max|score|; per stream, the first position whose top two scores lie
    within TOL).  ``scores`` (n, B, Q) score positions first .. first + n - 1
    of ``jax_tokens`` (B, T); only positions from the end of the prompt count
    (the caller passes them)."""
    tok = jax_tokens[:, first : first + scores.shape[0]].T  # (n, B)
    scale = np.abs(scores).max(-1)
    gap = (scores.max(-1) - np.take_along_axis(scores, tok[..., None], -1)[..., 0]) / scale
    top2 = np.sort(scores, -1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0]) <= TOL * scale  # (n, B)
    first_tie = np.where(ties.any(0), ties.argmax(0), scores.shape[0])
    return float(gap.max()), first_tie


def _agree_to_first_tie(port, jax_tokens, first, first_tie):
    for b in range(first_tie.shape[0]):
        m = first_tie[b]
        assert np.array_equal(port[b, first : first + m], jax_tokens[b, first : first + m]), (
            f"stream {b} parts from JAX before its first near-tie (position {first + m})")


SRNN_CASES = ["b2", "b32", "b64", "stream"]


@pytest.mark.parametrize("tag", SRNN_CASES)
def test_samplernn_jax_bf16_tokens_pass_teacher_forcing(case, tag):
    inp, port = case
    full, rf, prior_t = inp[f"srnn/jax_{tag}"], SRNN_FS[0], 2 * SRNN_FS[0]
    scores = port[f"srnn/tf_{tag}"][prior_t - rf :]  # positions prior_t ..
    assert len(set(full[0, prior_t:].tolist())) > 1, "degenerate decode"
    gap, _ = _teacher_forcing(scores, full, prior_t)
    assert gap <= TOL, gap


@pytest.mark.parametrize("tag", SRNN_CASES)
def test_samplernn_bf16_tokens_equal_jax_up_to_near_ties(case, tag):
    inp, port = case
    full, rf, prior_t = inp[f"srnn/jax_{tag}"], SRNN_FS[0], 2 * SRNN_FS[0]
    got = port[f"srnn/{tag}"]
    if tag == "stream":
        got = np.concatenate([inp["srnn/prompt_b2"], got], 1)
    assert got.shape == full.shape
    _, first_tie = _teacher_forcing(port[f"srnn/tf_{tag}"][prior_t - rf :], full, prior_t)
    _agree_to_first_tie(got, full, prior_t, first_tie)


def test_samplernn_bf16_routes_take_bf16_packs(case):
    """B=2 decodes in one decode_single call, B=64 in decode_chunk calls
    (K1's and K2's routes), the stream in decode_chunk calls; every pack is
    bf16."""
    _, port = case
    assert port["srnn/b2_single"].tolist() == ["torch.bfloat16"]
    assert port["srnn/b2_chunk"].tolist() == []
    assert port["srnn/b32_single"].tolist() == ["torch.bfloat16"]
    assert port["srnn/b32_chunk"].tolist() == []
    assert port["srnn/b64_single"].tolist() == []
    assert set(port["srnn/b64_chunk"].tolist()) == {"torch.bfloat16"}
    assert set(port["srnn/stream_chunk"].tolist()) == {"torch.bfloat16"}


def test_kv_stream_jax_bf16_tokens_pass_teacher_forcing(case):
    inp, port = case
    full, prior_t = inp["kv/jax"], inp["kv/prompt"].shape[1]
    assert len(set(full[0, prior_t:].tolist())) > 1, "degenerate decode"
    gap, _ = _teacher_forcing(port["kv/tf"][prior_t - 1 :], full, prior_t)
    assert gap <= TOL, gap


def test_kv_stream_bf16_tokens_equal_jax_up_to_near_ties(case):
    inp, port = case
    full, kvp = inp["kv/jax"], inp["kv/prompt"]
    prior_t = kvp.shape[1]
    _, first_tie = _teacher_forcing(port["kv/tf"][prior_t - 1 :], full, prior_t)
    _agree_to_first_tie(np.concatenate([kvp, port["kv/c7"]], 1), full, prior_t, first_tie)


def test_kv_stream_bf16_is_chunk_invariant_on_bf16_packs(case):
    _, port = case
    n = min(port["kv/c7"].shape[1], port["kv/c9"].shape[1])
    assert np.array_equal(port["kv/c7"][:, :n], port["kv/c9"][:, :n])
    assert set(port["kv/packs"].tolist()) == {"torch.bfloat16"}


# the control's outputs: (JAX's tokens, the control's free run, its teacher-forced
# scores, the scores' first step)
CONTROL_CASES = {"srnn_b32": ("srnn/jax_b32", "ctl/srnn_b32", "ctl/srnn_tf_b32", SRNN_FS[0]),
                 "srnn_b64": ("srnn/jax_b64", "ctl/srnn_b64", "ctl/srnn_tf_b64", SRNN_FS[0]),
                 "kv": ("kv/jax", "ctl/kv", "ctl/kv_tf", 1)}


@pytest.mark.parametrize("tag", CONTROL_CASES)
def test_twin_without_input_rounding_fails_the_checks(case, tag):
    """The control: the same bf16 weights with the products' inputs left in
    f32 (what a twin that skipped ``dot_input``'s or ``_dense_bf16``'s
    rounding computes).  The checks above must catch it: one of JAX's tokens
    lies beyond TOL of its row's maximum under the control's scores, or the
    control's free run parts from JAX's tokens before the first near-tie."""
    inp, port = case
    jax_key, run_key, tf_key, first_step = CONTROL_CASES[tag]
    full, run = inp[jax_key], port[run_key]
    prior_t = full.shape[1] - run.shape[1]
    gap, first_tie = _teacher_forcing(port[tf_key][prior_t - first_step :], full, prior_t)
    parted = any(not np.array_equal(run[b, : first_tie[b]],
                                    full[b, prior_t : prior_t + first_tie[b]])
                 for b in range(run.shape[0]))
    assert gap > TOL or parted, f"the control passed: largest gap {gap:.3e}"


WINDOW_CASES = {"tf_direct": ("win_tf/jax_direct", "win_tf/tf_direct", "win_tf/direct"),
                "tf_wide": ("win_tf/jax_wide", "win_tf/tf_wide", "win_tf/wide"),
                "jb": ("win_jb/jax", "win_jb/tf", "win_jb/tokens"),
                "jb_out_of_k8": ("win_jb_out/jax", "win_jb_out/tf", "win_jb_out/tokens")}


@pytest.mark.parametrize("tag", WINDOW_CASES)
def test_window_route_jax_bf16_tokens_pass_teacher_forcing(case, tag):
    inp, port = case
    jax_key, tf_key, _ = WINDOW_CASES[tag]
    full = inp[jax_key]
    first = full.shape[1] - N_STEPS
    assert len(set(full[0, first:].tolist())) > 1, "degenerate decode"
    gap, _ = _teacher_forcing(port[tf_key], full, first)
    assert gap <= TOL, gap


@pytest.mark.parametrize("tag", WINDOW_CASES)
def test_window_route_bf16_tokens_equal_jax_up_to_near_ties(case, tag):
    inp, port = case
    jax_key, tf_key, port_key = WINDOW_CASES[tag]
    full = inp[jax_key]
    first = full.shape[1] - N_STEPS
    assert port[port_key].shape == full.shape
    _, first_tie = _teacher_forcing(port[tf_key], full, first)
    _agree_to_first_tie(port[port_key], full, first, first_tie)


def test_window_route_builds_one_bf16_copy_a_call_and_a_stream(case):
    """generate past _K6_MAX_BATCH streams and JukeBox's generate outside
    K8's scope build the bf16 copy once a call; a re-feed stream of three
    chunks once."""
    _, port = case
    assert str(port["win_tf/copy_dtype"]) == "torch.bfloat16"
    assert int(port["win_tf/wide_copies"]) == 1
    assert int(port["win_jb_out/copies"]) == 1
    assert int(port["win_tf/refeed_copies"]) == 1
    assert port["win_tf/refeed"].shape == (WIDE_B, 27)


def test_kv_stream_outside_bf16_limits_warns_and_streams_f32(case):
    _, port = case
    msgs = port["warn/warnings"].tolist()
    assert len(msgs) == 1 and "limits for 16-bit weights" in msgs[0], msgs
    assert "f32 route" in msgs[0]
    assert set(port["warn/packs"].tolist()) == {"torch.float32"}
    assert np.array_equal(port["warn/bf16"], port["warn/f32"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _jax_side(sys.argv[1])
