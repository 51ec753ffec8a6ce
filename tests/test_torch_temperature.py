"""One sampling temperature a row, through every decode path of the port, on the CPU.

JAX's sampler divides a step's logits by ``jnp.asarray(temperature)``
broadcast over the rows (``mimikit_tpu/modules/targets.py:19-23``), so its
nets decode a scalar, a 1-tuple or one temperature an example (the training
monitor's ``temperature=(1.0, 0.75, 0.5, 0.1)``).  On the CPU each port
wrapper runs its kernel's plain twin, so this holds the twins, and the
plain step loops outside the kernel gates, to that rule, for SampleRNN
(``generate``, the chunked route, ``stream``), WaveNet (``generate``,
``stream``, the step loop of a prompt shorter than rf + 1), SimpleTransformer
(K6's route, the window route, the KV stream) and JukeBox (K8's route,
``stream``, the window route):

* a 1-tuple gives the same tokens as its scalar;
* each row of a decode at one temperature a row equals that row of the
  decode, with the same seed, at that row's temperature for every row;
* a sequence of another length than 1 or B raises ``ValueError``;
* the twins' scores with the noise set to zero are the argmax scores divided
  as JAX's sampler divides them, ``logits / t[b]`` (``targets._as_array``),
  to ``rtol=1e-6``.

The port runs in one subprocess for the module (``torch_port_worker.py
temperature``).  The kernels themselves take the same rule on the card
(``tests/test_torch_temperature_card.py``, ``chip_smoke.py`` phase 2).
"""
import numpy as np
import pytest

import jax.numpy as jnp
from mimikit_tpu.modules.targets import _as_array

from tests.torch_port_harness import run_port

TEMPS = (1.0, 0.75, 0.5, 0.1)
N_STEPS = 48
PATHS = ("samplernn", "samplernn_chunked", "samplernn_stream", "wavenet", "wavenet_stream",
         "wavenet_step_loop", "transformer", "transformer_window", "transformer_kv", "jukebox",
         "jukebox_stream", "jukebox_window")
TWINS = ("samplernn", "wavenet", "transformer", "transformer_kv", "jukebox")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port("temperature", {"temps": np.array(TEMPS), "n_steps": np.array(N_STEPS)},
                    str(tmp_path_factory.mktemp("temperature")))


@pytest.mark.parametrize("path", PATHS)
def test_a_one_tuple_decodes_as_its_scalar(port, path):
    np.testing.assert_array_equal(port[f"{path}/one"], port[f"{path}/scalar"])


@pytest.mark.parametrize("path", PATHS)
def test_each_row_decodes_as_at_its_own_temperature(port, path):
    rows, each = port[f"{path}/rows"], port[f"{path}/each"]
    assert rows.shape[0] == len(TEMPS)
    np.testing.assert_array_equal(rows, each)
    # the temperatures reach the tokens: the rows part from the decode at TEMPS[0]
    assert not np.array_equal(rows, port[f"{path}/scalar"])


@pytest.mark.parametrize("path", PATHS)
def test_a_wrong_number_of_temperatures_raises(port, path):
    assert str(port[f"{path}/wrong"]) == "ValueError"


@pytest.mark.parametrize("twin", TWINS)
def test_tempered_scores_are_jax_logits_over_each_rows_temperature(port, twin):
    assert bool(port["noise_is_the_decodes"])
    logits = port[f"scores/{twin}/logits"]
    assert logits.shape[:2] == (len(TEMPS), N_STEPS)
    want = np.asarray(jnp.asarray(logits) / _as_array(TEMPS, jnp.asarray(logits)))
    np.testing.assert_allclose(port[f"scores/{twin}/tempered"], want, rtol=1e-6)
