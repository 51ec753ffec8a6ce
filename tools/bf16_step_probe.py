"""Where the port's bf16 training loop first parts from JAX's, parameter by parameter.

Usage, on the CPU, from the root of a checkout (~3 min):
``python tools/bf16_step_probe.py [transformer,jukebox] [dump_dir]``.  For each
stateless net of ``tests/test_torch_train.py`` (the weights, data and
settings of ``tests/test_torch_bf16_train.py``) it runs JAX's bf16 loop (XLA's
excess precision off, as the test runs it) for 1, 2 and 3 steps from the same
start, and the port's the same way, and prints after each step, tensor by
tensor, how many parameters and Adam moments (mu, nu) differ and by how many
f32 ulps at most, with the loss of each step; the tensors are named as the
port's state dict names them.  With ``dump_dir`` the JAX side also writes
XLA's HLO of every computation it compiles there (``--xla_dump_to``), for
reading the fused step's fusions.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = (1, 2, 3)


def _moments(opt_state):
    """(mu, nu) of the optax Adam state inside ``opt_state``."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _moments(s)
            if found is not None:
                return found
    for name in ("inner_opt_state",):
        if hasattr(opt_state, name):
            return _moments(getattr(opt_state, name))
    return None


def jax_side(path: str, work: str, kinds) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mimikit_tpu as mmk
    from tests.test_torch_bf16_train import SR, TRAIN, _wav
    from tests.test_torch_train import _stateless_net
    from jax.flatten_util import ravel_pytree
    from tests.torch_port_harness import flatten

    wav = os.path.join(work, "a.wav")
    _wav(wav)
    ds = mmk.DatasetConfig(sources=(wav,), filename=os.path.join(work, "jax.h5"),
                           extractors=(mmk.Extractor.signal(SR),))
    db = ds.create(mode="w")
    out = {"work": np.array(work), "wav": np.array(wav), "jax_h5": np.array(ds.filename)}
    for kind in kinds:
        net = _stateless_net(kind, ds)
        params0 = jax.device_get(net.params)
        out.update(flatten(params0, f"{kind}/params0/"))
        out[f"{kind}/net_yaml"] = np.array(net.config.serialize())
        for n in STEPS:
            net.params = params0
            cfg = mmk.TrainARMConfig(root_dir=os.path.join(work, f"jax_{kind}_{n}"),
                                     **dict(TRAIN, max_epochs=n),
                                     trainer_kwargs={"data_seed": 5, "param_dtype": "bfloat16"})
            loop = mmk.TrainARMLoop.from_config(cfg, db, net)
            logged = []
            log_output = loop.metrics.log_output
            loop.metrics.log_output = lambda d, f=log_output: logged.append(dict(d)) or f(d)
            loop.run()
            db = ds.get(mode="r")
            out[f"{kind}/jax/{n}/losses"] = np.array([d["loss"] for d in logged])
            out.update(flatten(jax.device_get(loop.net.params), f"{kind}/jax/{n}/params/"))
            mu, nu = _moments(loop.opt_state)
            # the loop's Adam runs on the raveled parameters (flat_optimizer)
            unravel = ravel_pytree(params0)[1]
            mu, nu = unravel(mu), unravel(nu)
            out.update(flatten(jax.device_get(mu), f"{kind}/jax/{n}/mu/"))
            out.update(flatten(jax.device_get(nu), f"{kind}/jax/{n}/nu/"))
            if n == STEPS[-1]:
                out[f"{kind}/train_yaml"] = np.array(cfg.serialize())
    db.close()
    np.savez(path, **out)


def port_side(src: str, dst: str) -> None:
    import torch

    import mimikit_tpu_torch as mmk
    from tests.torch_port_worker import unflatten

    with np.load(src, allow_pickle=False) as f:
        inp = dict(f)
    from_jax = {"transformer": (mmk.SimpleTransformer, mmk.transformer_state_dict_from_jax),
                "jukebox": (mmk.JukeBox, mmk.jukebox_state_dict_from_jax),
                "wavenet": (mmk.WaveNet, mmk.wavenet_state_dict_from_jax)}
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))
    kinds = sorted({k.split("/")[0] for k in inp if k.endswith("/net_yaml")})
    out = {}
    for kind in kinds:
        cls, to_sd = from_jax[kind]
        for n in STEPS:
            db = ds.get(mode="r")
            cfg = mmk.Config.deserialize(str(inp[f"{kind}/train_yaml"]))
            cfg.max_epochs = n
            cfg.root_dir = f"{inp['work']}/port_{kind}_{n}"
            net_cfg = mmk.Config.deserialize(str(inp[f"{kind}/net_yaml"]))
            net_cfg.io_spec.bind_to(ds)
            net = cls.from_config(net_cfg, device="cpu")
            net.load_state_dict(to_sd(unflatten(inp, f"{kind}/params0/")), strict=True)
            loop = mmk.TrainARMLoop.from_config(cfg, db, net)
            loop.run()
            out[f"{kind}/port/{n}/losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
            names = {id(p): name for name, p in net.named_parameters()}
            state = loop.opt.adam.state
            for name, p in net.named_parameters():
                out[f"{kind}/port/{n}/params/{name}"] = p.detach().numpy()
            for p in loop.opt.params:
                st = state.get(p, {})
                if "exp_avg" in st:
                    out[f"{kind}/port/{n}/mu/{names[id(p)]}"] = st["exp_avg"].numpy()
                    out[f"{kind}/port/{n}/nu/{names[id(p)]}"] = st["exp_avg_sq"].numpy()
            for what in ("params", "mu", "nu"):
                sd = to_sd(unflatten(inp, f"{kind}/jax/{n}/{what}/"))
                for name, v in sd.items():
                    out[f"{kind}/jaxsd/{n}/{what}/{name}"] = torch.as_tensor(v).numpy()
    np.savez(dst, **out)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def main() -> int:
    if sys.argv[1:2] == ["--port"]:
        port_side(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--jax"]:
        jax_side(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
        return 0
    kinds = (sys.argv[1] if len(sys.argv) > 1 else "transformer,jukebox").split(",")
    dump = sys.argv[2] if len(sys.argv) > 2 else None
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        jpath, ppath = os.path.join(tmp, "jax.npz"), os.path.join(tmp, "port.npz")
        flags = " --xla_allow_excess_precision=false"
        if dump:
            flags += f" --xla_dump_to={dump}"
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + flags).strip())
        subprocess.run([sys.executable, __file__, "--jax", jpath, tmp, ",".join(kinds)],
                       check=True, env=env, cwd=ROOT)
        subprocess.run([sys.executable, __file__, "--port", jpath, ppath], check=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
        with np.load(jpath) as f:
            jx = dict(f)
        with np.load(ppath) as f:
            pt = dict(f)
    for kind in kinds:
        for n in STEPS:
            print(f"{kind} after step {n}: losses JAX {jx[f'{kind}/jax/{n}/losses']}, port"
                  f" {pt[f'{kind}/port/{n}/losses']}")
            for what in ("params", "mu", "nu"):
                rows = []
                for key in sorted(k for k in pt if k.startswith(f"{kind}/port/{n}/{what}/")):
                    name = key.split(f"/{what}/", 1)[1]
                    ref = pt.get(f"{kind}/jaxsd/{n}/{what}/{name}")
                    if ref is None:
                        continue
                    got = pt[key]
                    d = int((got != ref).sum())
                    if d:
                        rows.append((d, name, got.size, ulps(got, ref),
                                     float(np.abs(got - ref).max())))
                total = sum(r[0] for r in rows)
                print(f"  {what}: {total} elements differ")
                for d, name, size, u, mx in sorted(rows, reverse=True)[:12]:
                    print(f"    {name}: {d} of {size}, at most {u} ulps ({mx:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
