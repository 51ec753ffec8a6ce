"""The port's ensemble generation against the JAX package's, on the CPU.

* ``Resample``'s numpy and tensor paths against JAX's ``np_func`` and
  ``jax_func`` at 22,050 <-> 16,000 and 16,000 <-> 8,000 Hz, within 1e-5 of
  the signal's peak; its ``sr`` metadata, ``unit`` and ``inv``;
* the seeded patterns (``Pseq`` of ``Pbind`` s over ``Pwhite``, ``Prand``
  and a nested ``Pseq``): the same event stream as JAX's;
* ``dtw`` on cost matrices with ties, subsequence and not: the same paths
  (the backtrack's ``min`` over (D, i, j)) and costs;
* ``NearestNextNeighbor``'s steps as ``tests/test_ensemble.py:84-95``, and
  its cosine distances against scikit-learn's (which the JAX package calls)
  within 1e-6;
* ``nearest_neighbor``, ``cum_entropy``, ``repeat_rate`` and ``frame``
  against JAX's within 1e-6; ``VotingEnsemble``'s weights and vote
  against JAX's;
* ``EnsembleGenerator`` over two port checkpoints (SampleRNN at 16 kHz,
  WaveNet at 22.05 kHz, as ``tests/test_ensemble.py:29-81``), which JAX
  opens: each argmax event's tokens equal JAX's decode of the same prompt
  (the port's resampled, mu-law prompt fed to JAX's ``GenerateLoopV2`` as
  ``EnsembleGenerator.run_event`` feeds it), token for token; sampled events
  are held to their shape and to output past the prompt; every prompt's
  classes lie in [0, q) (the port clips a window past +-1, which JAX's
  mu-law would send past q - 1);
* ``demos.ensemble_generator`` and ``demos.checkpoint_k_bests`` run on the
  CPU on a third checkpoint, a SampleRNN at 250 Hz (the demos' prompts are
  one second long: at 250 Hz the plain decode steps through them quickly).

JAX runs in this process, the port in one subprocess
(``torch_port_worker.py ensemble``).
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk

from tests.torch_port_harness import start_port
from tests.torch_port_worker_patterns import ensemble_patterns

RESAMPLE_TOL = 1e-5  # of the signal's peak
TOL = 1e-6
PAIRS = ((22050, 16000), (16000, 22050), (16000, 8000), (8000, 16000))
# (checkpoint, seconds, temperature): two argmax events, then one sampled event each
EVENTS = (("srnn", 0.03, None), ("wn", 0.03, None), ("srnn", 0.01, 1.0), ("wn", 0.01, 0.5))
PROMPT_N, MAX_SECONDS = 221, 0.1


def _wav(path, sr, seconds=2.0, f0=330.0):
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    y = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.random.default_rng(3).standard_normal(t.size)
    wavfile.write(path, sr, (y / np.abs(y).max() * 0.9 * 32767).astype(np.int16))


def _dtw_cases(rng):
    """Integer costs (ties everywhere) and random ones, both modes."""
    cases = []
    for shape in ((5, 9), (7, 7), (4, 12)):
        C = rng.integers(0, 3, shape).astype(np.float64)
        cases += [(C, True), (C, False)]
    C = rng.random((6, 15))
    cases += [(C, True), (C, False), (np.zeros((4, 6)), True), (np.ones((5, 5)), False)]
    return cases


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ensemble"))
    rng = np.random.default_rng(17)
    # the inputs, then the port's run, while JAX computes its references
    x = rng.standard_normal((2, 441)).astype(np.float32)
    dtw = _dtw_cases(rng)
    corpus = rng.random((50, 8)).astype(np.float32)
    prompt = corpus[10:14]  # an exact subsequence: matched at 14
    nx, ny = rng.standard_normal((6, 8)).astype(np.float32), rng.standard_normal((30, 8)).astype(
        np.float32)
    ny[4] = 0.0  # a zero frame: similarity 0
    X, Y = np.abs(rng.standard_normal((20, 6))).astype(np.float32), np.abs(
        rng.standard_normal((40, 6))).astype(np.float32)
    seq = rng.integers(0, 7, 60)
    wav16, wav22, wav250 = (os.path.join(work, f"a{sr}.wav") for sr in (16, 22, 250))
    _wav(wav16, 16000)
    _wav(wav22, 22050, f0=220.0)
    _wav(wav250, 250, f0=30.0)
    inp = {"resample/x": x, "resample/pairs": np.array(json.dumps(PAIRS)), "work": np.array(work),
           "dtw/n": np.array(len(dtw)), "nnn/corpus": corpus, "nnn/prompt": prompt,
           "nnn/x": nx, "nnn/y": ny, "nn/X": X, "nn/Y": Y, "nn/seq": seq,
           "wav16": np.array(wav16), "wav22": np.array(wav22), "wav250": np.array(wav250),
           "ens/prompt": (rng.uniform(-1, 1, (2, PROMPT_N)) * 0.5).astype(np.float32),
           "ens/events": np.array(json.dumps(EVENTS)),
           "ens/max_seconds": np.array(MAX_SECONDS)}
    for k, (C, subseq) in enumerate(dtw):
        inp[f"dtw/{k}/C"], inp[f"dtw/{k}/subseq"] = C, np.array(subseq)
    run = start_port("ensemble", inp, work)

    jx = {"dtw/n": len(dtw)}
    for a, b in PAIRS:
        r = mmk.Resample(a, b)
        jx[f"resample/{a}_{b}/np"] = np.asarray(r.np_func(x), np.float32)
        jx[f"resample/{a}_{b}/torch"] = np.asarray(r.jax_func(jnp.asarray(x)))
    jx["patterns"] = json.dumps(list(ensemble_patterns(mmk).asStream()))
    for k, (C, subseq) in enumerate(dtw):
        jx[f"dtw/{k}/D"], jx[f"dtw/{k}/path"] = mmk.dtw(C, subseq=subseq)
    nnn = mmk.NearestNextNeighbor(feature=lambda v: v, snd=corpus)
    jx["nnn/out1"] = nnn.generate_step((prompt[None],), t=100)
    jx["nnn/starts1"] = np.array(nnn._starts)
    jx["nnn/out2"] = nnn.generate_step((prompt[None],), t=101)
    jx["nnn/out3"] = nnn.generate_step((prompt[None],), t=5)
    from sklearn.metrics import pairwise_distances

    jx["nnn/cos"] = pairwise_distances(np.abs(nx), np.abs(ny), metric="cosine")
    jx["nnn/path"] = mmk.models.nnn.optimal_path(nx, ny)
    jx["nn/dists"], jx["nn/idx"] = mmk.nearest_neighbor(X, Y)
    jx["nn/cum_sum"] = mmk.cum_entropy(seq)
    jx["nn/cum_t"] = mmk.cum_entropy(seq, reduce="none", neg_diff=False)
    jx["nn/repeat"] = mmk.repeat_rate(seq, 4, 2)
    jx["nn/frame"] = mmk.frame(seq, 4, 3)

    class Const:
        def __init__(self, v):
            self.v = v

        def before_generate(self, *a):
            pass

        def after_generate(self, *a):
            return None

        def generate_step(self, inputs, *, t=0, **kw):
            return (np.full((1, 1), self.v, np.float32),)

    vote = mmk.VotingEnsemble([Const(1.0), Const(3.0), Const(-2.0)], weights=[1, 2, 1])
    jx["vote/weights"] = np.array(vote.weights)
    jx["vote/step"] = np.asarray(vote.generate_step((np.zeros((1, 4)),), t=0))
    port = run.result()
    # JAX decodes each argmax event's prompt with the port's weights, as run_event does
    nets = {}
    for (root, id_), kind in zip(port["ens/ckpts"], ("SampleRNN", "WaveNet")):
        # the bank's config and parameter tree as JAX reads them; its
        # Checkpoint.network would first init the net eagerly (~10 s here)
        ck = mmk.Checkpoint(id=str(id_), epoch=1, root_dir=str(root))
        cfg = ck.network_config
        cfg.io_spec.bind_to(ck.dataset_config)
        nets[kind] = cfg.owner_class.from_config(cfg)
        nets[kind].params = jax.tree_util.tree_map(jnp.asarray, ck.state_dict)
        jx[f"type/{kind}"] = type(nets[kind]).__name__
    for k in range(int(port["ens/n_events"])):
        if not np.isnan(port[f"ens/{k}/temperature"]):
            continue
        net, prompt = nets[str(port[f"ens/{k}/kind"])], port[f"ens/{k}/prompt"]
        loop = mmk.GenerateLoopV2(
            mmk.GenerateLoopV2.Config(parameters={}, display_waveform=False,
                                      write_waveform=False, yield_inversed_outputs=False),
            network=net, n_steps=int(port[f"ens/{k}/n_steps"]),
            dataloader=[[np.ones(1), prompt]], logger=None)
        jx[f"ens/{k}/tokens"] = np.asarray(next(iter(loop.run()))[0])[:, prompt.shape[1]:]
    return jx, port


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}_{p[1]}")
@pytest.mark.parametrize("path", ["np", "torch"])
def test_resample_matches_jax(case, pair, path):
    jx, port = case
    key = f"resample/{pair[0]}_{pair[1]}/{path}"
    got, want = port[key], jx[key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}_{p[1]}")
def test_resample_metadata_unit_and_inverse(case, pair):
    _, port = case
    a, b = pair
    assert int(port[f"resample/{a}_{b}/sr"]) == b
    assert list(port[f"resample/{a}_{b}/inv"]) == [b, a, b]


def test_patterns_stream_as_jax(case):
    jx, port = case
    got, want = json.loads(str(port["patterns"])), json.loads(jx["patterns"])
    assert len(got) == len(want) > 10
    assert got == want


def test_dtw_paths_and_costs_with_ties(case):
    jx, port = case
    for k in range(int(jx["dtw/n"])):
        np.testing.assert_array_equal(port[f"dtw/{k}/path"], jx[f"dtw/{k}/path"], err_msg=str(k))
        np.testing.assert_array_equal(port[f"dtw/{k}/D"], jx[f"dtw/{k}/D"], err_msg=str(k))


def test_nearest_next_neighbor_steps(case):
    jx, port = case
    for key in ("nnn/out1", "nnn/starts1", "nnn/out2", "nnn/out3"):
        np.testing.assert_array_equal(port[key], jx[key], err_msg=key)
    assert port["nnn/out1"].shape == (1, 1, 8) and int(port["nnn/starts1"][0]) == 15


def test_nnn_cosine_distances_and_path(case):
    jx, port = case
    np.testing.assert_allclose(port["nnn/cos"], jx["nnn/cos"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(port["nnn/path"], jx["nnn/path"])


@pytest.mark.parametrize("key", ["nn/dists", "nn/idx", "nn/cum_sum", "nn/cum_t", "nn/repeat",
                                 "nn/frame"])
def test_neighbor_scores_match_jax(case, key):
    jx, port = case
    np.testing.assert_allclose(port[key], jx[key], rtol=TOL, atol=TOL)


def test_voting_ensemble(case):
    """The weights normalised and the weighted vote of three constant nets
    (the port's return a tensor, JAX's an array), as JAX's."""
    jx, port = case
    for key in ("vote/weights", "vote/step"):
        np.testing.assert_allclose(port[key], jx[key], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port["vote/step"], [[1.25]])


def test_ensemble_runs_every_event(case):
    jx, port = case
    assert [str(port[f"ens/{k}/kind"]) for k in range(int(port["ens/n_events"]))] == [
        "SampleRNN", "WaveNet", "SampleRNN", "WaveNet"]
    assert jx["type/SampleRNN"] == "SampleRNN" and jx["type/WaveNet"] == "WaveNet"
    out = port["ens/out"]
    assert out.shape == (2, int(MAX_SECONDS * 22050)) and str(port["ens/device"]) == "cpu"
    # the windows are clipped to [-1, 1]: every prompt class lies in [0, q)
    for k in range(int(port["ens/n_events"])):
        assert 0 <= port[f"ens/{k}/prompt"].min() and port[f"ens/{k}/prompt"].max() < 32
    assert np.isfinite(out).all() and np.any(out[:, PROMPT_N:] != 0)


@pytest.mark.parametrize("k", [0, 1])
def test_argmax_event_matches_jax_from_the_same_prompt(case, k):
    jx, port = case
    assert np.isnan(port[f"ens/{k}/temperature"])
    got, want = port[f"ens/{k}/tokens"], jx[f"ens/{k}/tokens"]
    assert got.shape == want.shape == (2, int(port[f"ens/{k}/n_steps"]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 3])
def test_sampled_event_shape(case, k):
    _, port = case
    assert float(port[f"ens/{k}/temperature"]) == EVENTS[k][2]
    toks = port[f"ens/{k}/tokens"]
    sr = 16000 if EVENTS[k][0] == "srnn" else 22050
    assert toks.shape == (2, int(sr * EVENTS[k][1]))
    assert toks.min() >= 0 and toks.max() < 32


def test_demos_run(case):
    _, port = case
    ens = port["demo/ensemble"]
    assert ens.shape == (3, int(1.2 * 250)) and np.isfinite(ens).all()
    assert np.any(ens[:, 250:275] != 0)
    bests = port["demo/bests"]
    assert bests.shape[0] == 1 and np.isfinite(bests).all()
