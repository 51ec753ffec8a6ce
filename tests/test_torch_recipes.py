"""The main path's recipes on the port, on the CPU.

* ``mimikit_tpu_torch.loops.generate_chunks`` against the JAX package's,
  from one JAX bank (a SampleRNN-3 trained a step) with the same arguments
  and seed: the same prompts (the positions drawn from ``RandomState(seed)``
  read the same samples), the same temperature walk (every chunk's
  temperatures, recorded from ``GenerateLoopV2``), the same file keys and
  shapes and the same returned shape; the file read back through the port's
  h5 layer, and the npz container (a machine without h5py) the same;
* the demos (``demos.srnn`` and ``demos.serving``) end to end with
  ``device="cpu"`` on a synthesized tone, at ``tests/test_demos.py``'s tiny
  overrides: the srnn recipe's weight-normed net trains an epoch and writes
  its ``epoch=1.ckpt``; the serving recipe streams two chunks and decodes
  its stream batch sharded over two CPU devices;
* ``mmk.parallel.sharded_generate`` and ``sharded_stream_tokens`` over two
  CPU devices for each family (SampleRNN, WaveNet, SimpleTransformer,
  JukeBox): argmax rows equal the unsharded call's (as
  ``tests/test_parallel.py:462`` holds JAX); a batch the devices do not
  divide decodes unsharded with a warning naming why; the device copies
  are cached against the parameters and made anew after they change;
* ``MMK_STREAM_PIPELINE=0`` gives the same chunks as the read-behind
  pipeline, on SampleRNN's state-carrying stream and on WaveNet's
  (``tests/test_streaming.py:506-536``), each chunk read before the next is
  launched.

JAX runs in this process; the port in one subprocess for the module
(``torch_port_worker.py recipes``).
"""
import os

import numpy as np
import pytest
from scipy.io import wavfile

import mimikit_tpu as mmk

from tests.torch_port_harness import run_port

SR = 16000
CHUNKS = dict(batch_size=4, n_chunks=3, chunk_seconds=0.002, prompt_seconds=0.004, seed=7)
FAMILIES = ("samplernn", "wavenet", "transformer", "jukebox")


def _wav(path, seconds=1.0):
    t = np.arange(int(SR * seconds)) / SR
    y = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.random.default_rng(0).standard_normal(t.size)
    wavfile.write(path, SR, (y * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import h5py

    from mimikit_tpu.loops.generate_chunks import generate_chunks

    work = str(tmp_path_factory.mktemp("recipes"))
    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16),
                             extractor=ds.extractors[0])
    net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(frame_sizes=(8, 4, 2), hidden_dim=16,
                                                         io_spec=io))
    net.seed(0)
    net.init_params()
    cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, "jax_tr"), batch_size=2,
                             batch_length=64, tbptt_chunk_length=256, max_epochs=1,
                             limit_train_batches=1, MONITOR_TRAINING=False, every_n_epochs=1)
    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    loop.run()
    db.close()

    temps, run = [], mmk.GenerateLoopV2.run

    def recorded(self):
        temps.append(np.array(self.config.parameters["temperature"]))
        yield from run(self)

    out = os.path.join(work, "jax_chunks.h5")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mmk.GenerateLoopV2, "run", recorded)
        tracks = generate_chunks(mmk.Checkpoint(loop.hash_, 1, cfg.root_dir),
                                 out_filename=out, **CHUNKS)
    with h5py.File(out, "r") as f:
        jx = {"keys": sorted(f.keys()), "shapes": {k: f[k].shape for k in f},
              "prompts": np.asarray(f["0"])}
    jx["temps"], jx["tracks_shape"] = np.stack(temps), tracks.shape
    os.makedirs(os.path.join(work, "demos"))
    _wav(os.path.join(work, "demos", "tone.wav"))
    inp = {"work": np.array(work), "bank_root": np.array(cfg.root_dir),
           "bank_id": np.array(loop.hash_),
           **{f"chunks/{k}": np.array(v) for k, v in CHUNKS.items()}}
    return jx, run_port("recipes", inp, work)


@pytest.mark.parametrize("layer", ["h5py", "npz"])
def test_generate_chunks_matches_jax(case, layer):
    jx, port = case
    p = f"chunks/{layer}/"
    assert port[p + "keys"].tolist() == jx["keys"] == ["0", "1", "2"]
    for k in jx["keys"]:
        assert tuple(port[f"{p}shape/{k}"]) == jx["shapes"][k], k
    assert tuple(port[p + "tracks_shape"]) == jx["tracks_shape"]
    np.testing.assert_array_equal(port[p + "prompts"], jx["prompts"])
    np.testing.assert_array_equal(port[p + "temps"], jx["temps"])


def test_generate_chunks_prompts_each_chunk_with_the_tail_before_it(case):
    """Chunk i's prompt (recorded at its decode) is the last prompt-length
    samples of the track before it."""
    _, port = case
    n_prompt = int(SR * CHUNKS["prompt_seconds"])
    tracks = port["chunks/h5py/tracks"]
    for i in range(1, CHUNKS["n_chunks"]):
        end = n_prompt + (i - 1) * int(SR * CHUNKS["chunk_seconds"])
        np.testing.assert_array_equal(port[f"chunks/h5py/prompt/{i}"],
                                      tracks[:, end - n_prompt : end], err_msg=str(i))


def test_generate_chunks_is_not_in_the_flat_namespace(case):
    _, port = case
    assert not bool(port["chunks/flat"])


def test_srnn_demo_trains_the_weight_normed_recipe_net(case):
    _, port = case
    assert "epoch=1.ckpt" in port["demo/srnn/files"].tolist()
    assert bool(port["demo/srnn/weight_norm"]) and bool(port["demo/srnn/kernel_gate"])
    assert np.all(np.isfinite(port["demo/srnn/losses"]))


def test_serving_demo_streams_and_shards(case):
    _, port = case
    audio = port["demo/serving/audio"]
    assert audio.shape == (2 * 80,) and np.isfinite(audio).all()
    assert tuple(port["demo/serving/outs_shape"]) == (4, 4000 + 80)
    assert int(port["demo/serving/warnings"]) == 0  # it sharded over the two CPU devices


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_generate_matches_unsharded(case, family):
    _, port = case
    a, b = port[f"sharded/{family}/generate"], port[f"sharded/{family}/unsharded"]
    assert a.shape == b.shape and len(set(b[:, -12:].ravel().tolist())) > 1
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_stream_tokens_matches_unsharded(case, family):
    _, port = case
    np.testing.assert_array_equal(port[f"sharded/{family}/stream"],
                                  port[f"sharded/{family}/stream_unsharded"])


@pytest.mark.parametrize("what", ["generate", "stream"])
def test_sharding_falls_back_with_a_warning(case, what):
    """8 streams over 3 devices, and one device: unsharded, the output the
    unsharded call's, and a warning saying why."""
    _, port = case
    msgs = port[f"fallback/{what}/warnings"].tolist()
    assert any("do not divide over 3 devices" in m for m in msgs), msgs
    assert any("sharding needs at least 2" in m for m in msgs), msgs
    assert bool(port[f"fallback/{what}/equal"])


def test_device_copies_follow_the_parameters(case):
    """A copy a device, reused while the parameters stand, made anew after
    an in-place update (a training step) or a loaded state_dict."""
    _, port = case
    assert port["copies"].tolist() == [True, False, False, True]


@pytest.mark.parametrize("family", ["samplernn", "wavenet"])
def test_stream_pipeline_opt_out_gives_the_same_chunks(case, family):
    _, port = case
    on, off = port[f"pipeline/{family}/on"], port[f"pipeline/{family}/off"]
    assert on.shape == off.shape == (2, 4 * 16)
    np.testing.assert_array_equal(on, off)
    # the device chunks launched when each chunk was yielded: one ahead with
    # the pipeline, none ahead without it
    launched_on, launched_off = port[f"pipeline/{family}/on_launched"], \
        port[f"pipeline/{family}/off_launched"]
    np.testing.assert_array_equal(launched_on, launched_off + 1)
