"""The port's losses against the JAX package's, on the CPU.

Each loss of ``modules/loss_functions.py`` past cross-entropy and
``MeanL1Prop`` (``WeightedL1``, ``DiffOverTime``, ``DistanceOverTime``,
``MaximizeStd``, ``MaximizeMagnitude``, ``ScaledOutputsL1``,
``Mean2dDiff``, ``CosineSimilarity``, ``AngularDistance`` in both
reductions, ``ElementWiseAngularDistance``), and the five objectives that
``Objective.get_criterion`` builds from them: the value and its gradient
with respect to the output (of the sum, for a matrix), within 1e-6 (atol
and rtol).  ``DistanceOverTime``'s gradient is NaN in both packages (the
norm of each frame's zero distance to itself), and is held to that.
Inputs are drawn from a numpy seed; JAX runs in this process, the port in
one subprocess (``torch_port_worker.py losses``).
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import mimikit_tpu as mmk
from mimikit_tpu.modules import loss_functions as lf

from tests.torch_port_harness import start_port

TOL = 1e-6
# tag: (name, kwargs, kind); kind "xy" takes two frame matrices, "objective" an
# Objective's type and params, else (B, T, F) outputs and targets
CASES = {
    "WeightedL1": ("WeightedL1", {}, "btf"),
    "DiffOverTime": ("DiffOverTime", {}, "btf"),
    "DistanceOverTime": ("DistanceOverTime", {}, "btf"),
    "MaximizeStd": ("MaximizeStd", {}, "btf"),
    "MaximizeMagnitude": ("MaximizeMagnitude", {}, "btf"),
    "ScaledOutputsL1": ("ScaledOutputsL1", {"seed": 3}, "btf"),
    "Mean2dDiff": ("Mean2dDiff", {}, "btf"),
    "CosineSimilarity": ("CosineSimilarity", {}, "xy"),
    "AngularDistance": ("AngularDistance", {}, "xy"),
    "AngularDistance_none": ("AngularDistance", {"reduction": "none"}, "xy"),
    "AngularDistance_abs": ("AngularDistance", {"reduction": "sum"}, "xy_abs"),
    "ElementWiseAngularDistance": ("ElementWiseAngularDistance", {}, "btf"),
    "obj_WeightedL1": ("WeightedL1", {"eps": 1e-12}, "objective"),
    "obj_DiffOverTime": ("DiffOverTime", {}, "objective"),
    "obj_MaximizeMagnitude": ("MaximizeMagnitude", {}, "objective"),
    "obj_MaximizeStd": ("MaximizeStd", {}, "objective"),
    "obj_ElementWiseAngularDistance": ("ElementWiseAngularDistance", {"eps": 1e-7},
                                       "objective"),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("losses"))
    rng = np.random.default_rng(21)
    inp, crits = {"cases": np.array(json.dumps(CASES))}, {}
    for tag, (name, kw, kind) in CASES.items():
        if kind.startswith("xy"):
            a = rng.standard_normal((6, 8)).astype(np.float32)
            b = rng.standard_normal((9, 8)).astype(np.float32)
            if kind == "xy_abs":  # no negative entry: the doubled scale
                a, b = np.abs(a), np.abs(b)
        else:
            a = rng.standard_normal((3, 7, 5)).astype(np.float32)
            b = rng.standard_normal((3, 7, 5)).astype(np.float32)
        crits[tag] = (mmk.Objective(name, params=kw).get_criterion() if kind == "objective"
                      else getattr(lf, name)(**kw))
        inp[f"{tag}/a"], inp[f"{tag}/b"] = a, b
    run = start_port("losses", inp, work)  # the port runs while JAX computes

    @jax.jit
    def every_loss(args):
        # one compile for every case: eager flax/jnp ops compile one by one
        out = {}
        for tag, crit in crits.items():
            a, b = args[tag]
            out[f"{tag}/value"] = crit(a, b)
            out[f"{tag}/grad"] = jax.grad(lambda o: jnp.sum(crit(o, b)))(a)
        return out

    jx = {k: np.asarray(v) for k, v in every_loss(
        {tag: (inp[f"{tag}/a"], inp[f"{tag}/b"]) for tag in CASES}).items()}
    jx.update({f"{tag}/type": type(crit).__name__ for tag, crit in crits.items()})
    return jx, run.result()


@pytest.mark.parametrize("tag", list(CASES))
@pytest.mark.parametrize("what", ["value", "grad"])
def test_loss_matches_jax(case, tag, what):
    jx, port = case
    got, want = port[f"{tag}/{what}"], jx[f"{tag}/{what}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_distance_over_time_gradient_is_nan_in_both(case):
    jx, port = case
    assert np.isnan(jx["DistanceOverTime/grad"]).all()
    assert np.isnan(port["DistanceOverTime/grad"]).all()


@pytest.mark.parametrize("tag", [t for t in CASES if t.startswith("obj_")])
def test_objective_criterion_is_the_named_loss(case, tag):
    """``Objective.get_criterion`` builds the loss the objective names (it
    raised ``NotImplementedError`` for these before)."""
    jx, port = case
    assert str(port[f"{tag}/type"]) == jx[f"{tag}/type"] == CASES[tag][0]
