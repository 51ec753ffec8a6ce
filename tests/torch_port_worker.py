"""Port side of the ``tests/test_torch_*.py`` parity tests.

Run as ``python tests/torch_port_worker.py <task> <in.npz> <out.npz>``.  It
imports only ``torch``, numpy and ``mimikit_tpu_torch`` — never jax nor
``mimikit_tpu``, which the calling test process has loaded (the two
frameworks are kept in separate processes).  Every test module runs one
worker process for all of its cases and exchanges arrays through ``.npz``:
JAX parameter trees travel flattened with ``/``-joined keys.
"""
import contextlib
import copy
import dataclasses as dtc
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import mimikit_tpu_torch as mmk
from mimikit_tpu_torch.ops import samplernn_decode as sd


def unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_net(inp: dict, tag: str):
    """The port's SampleRNN from the JAX-written YAML, with the JAX weights."""
    cfg = mmk.Config.deserialize(str(inp[f"{tag}yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    net = mmk.SampleRNN.from_config(cfg, device="cpu").eval()
    sd_ = mmk.samplernn_state_dict_from_jax(unflatten(inp, f"{tag}params/"))
    net.load_state_dict(sd_, strict=True)
    return net, sd_


def t(x):
    return torch.from_numpy(np.asarray(x))


def modules_task(inp: dict) -> dict:
    out = {}
    x = inp["mulaw_x"]
    toks = inp["mulaw_tokens"]
    mc, me = mmk.MuLawCompress(256, 0.7), mmk.MuLawExpand(256, 0.7)
    out["mulaw_compress_np"] = mc(x)
    out["mulaw_compress_torch"] = mc(t(x)).numpy()
    out["mulaw_expand_np"] = me(toks)
    out["mulaw_expand_torch"] = me(t(toks)).numpy()
    out["mish"] = mmk.mish(t(inp["mish_x"])).numpy()
    sig = inp["signal_x"]
    out["normalize_np"] = mmk.Normalize()(sig)
    out["normalize_torch"] = mmk.Normalize()(t(sig)).numpy()
    out["remove_dc_np"] = mmk.RemoveDC()(sig)
    out["remove_dc_torch"] = mmk.RemoveDC()(t(sig)).numpy()
    out["file_to_signal"] = mmk.FileToSignal(16000)(str(inp["wav_path"]))

    net, sd_ = load_net(inp, "")
    out.update({f"sd/{k}": v.numpy() for k, v in sd_.items()})
    out["state_dict_keys"] = np.array(sorted(net.state_dict()))
    with torch.no_grad():
        n_t = len(net.frame_sizes)
        for i in range(n_t):
            out[f"tier_in_{i}"] = net.tiers[i].input_module((t(inp[f"tier_in_{i}_x"]),)).numpy()
        for i in range(n_t - 1):
            y, ((c, h),) = net.tiers[i].rnn.step(
                t(inp[f"rnn_{i}_x"]), ((t(inp[f"rnn_{i}_c"]), t(inp[f"rnn_{i}_h"])),)
            )
            out[f"rnn_{i}_y"], out[f"rnn_{i}_c2"], out[f"rnn_{i}_h2"] = y.numpy(), c.numpy(), h.numpy()
            out[f"up_{i}"] = net.tiers[i].up_sampler(t(inp[f"up_{i}_x"])).numpy()
        out["mlp"] = net.output_modules[0].estimator(t(inp["mlp_x"])).numpy()
        out["head_argmax"] = net.output_modules[0](t(inp["mlp_x"])).numpy()
    return out


def sample_rnn_task(inp: dict) -> dict:
    out = {}
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("cfg")}):
        net, _ = load_net(inp, f"{tag}/")
        p = f"{tag}/"
        seq = t(inp[p + "seq"]).to(torch.int32)
        B, L = seq.shape
        rf = net.rf
        with torch.no_grad():
            out[p + "forward"] = net((seq.long(),))[0][0].numpy()
        out[p + "in_gate"] = np.array(mmk.supports_kernel_decode(net))
        # teacher-forced scores of the plain twin over the whole sequence
        state = sd.init_decode_state(net, seq)
        _, scores = sd.decode_plain(net, seq, state, rf, L - rf, rf, L - rf, 0, None,
                                    return_scores=True)
        out[p + "tf_logits"] = scores.transpose(0, 1).numpy()
        prompt = inp[p + "prompt"]
        n = int(inp["n_steps"])
        out[p + "generate"] = net.generate((prompt,), n)[0].numpy()
        net._CHUNKED_MIN_B, net._CHUNK = 1, 16  # decode_chunk, several chunks
        out[p + "generate_chunked"] = net.generate((prompt,), n)[0].numpy()
        stream = mmk.stream_tokens(net, (prompt,), 7)
        out[p + "stream"] = np.concatenate([next(stream) for _ in range(n // 7)], 1)
        stream.close()
        sampled = net.generate((prompt,), n, temperature=0.9, seed=5)[0].numpy()
        stream = mmk.stream_tokens(net, (prompt,), 9, temperature=0.9, seed=5)
        out[p + "sampled"] = sampled
        out[p + "sampled_stream"] = np.concatenate([next(stream) for _ in range(n // 9)], 1)
        stream.close()
        audio = mmk.stream_audio(net, (prompt,), 9, temperature=0.9, seed=5)
        out[p + "audio"] = next(audio)
        audio.close()
    return out


def fused_lstm_task(inp: dict) -> dict:
    """The fused layer's plain path (CPU tensors): outputs and the six
    gradients for the given cotangents, and with only h_all's cotangent (the
    others None); and lstm_backward_plain against autograd through
    lstm_forward_plain."""
    from mimikit_tpu_torch.ops import fused_lstm as fl

    out = {}
    for tag in sorted({k.split("/")[0] for k in inp}):
        p = f"{tag}/"
        args = [t(inp[p + n]).clone().requires_grad_() for n in ("x", "Wi", "Wh", "b", "h0", "c0")]
        cts = [t(inp[p + n]) for n in ("dh_all", "dh_T", "dc_T")]
        res = fl.fused_lstm_layer(*args)
        for n, v in zip(("h_all", "h_T", "c_T"), res):
            out[p + n] = v.detach().numpy()
        for n, g in zip(("dx", "dWi", "dWh", "db", "dh0", "dc0"), torch.autograd.grad(res, args, cts)):
            out[p + "grad_" + n] = g.numpy()
        res = fl.fused_lstm_layer(*args)
        for n, g in zip(("dx", "dWi", "dWh", "db", "dh0", "dc0"), torch.autograd.grad(res[0], args, cts[0])):
            out[p + "grad_h_only_" + n] = g.numpy()
        # the written-out backward against autograd through the plain forward
        x, Wi, Wh, b, h0, c0 = args
        T, B, D = x.shape
        xi = (x.reshape(T * B, D) @ Wi + b).reshape(T, B, -1).detach().requires_grad_()
        wh, h0_, c0_ = (a.detach().clone().requires_grad_() for a in (Wh, h0, c0))
        h_all, c_all, gates = fl.lstm_forward_plain(xi, wh, h0_, c0_)
        auto = torch.autograd.grad((h_all, h_all[-1], c_all[-1]), (xi, wh, h0_, c0_), cts)
        written = fl.lstm_backward_plain(*cts, gates.detach(), c_all.detach(), h_all.detach(),
                                         h0_.detach(), c0_.detach(), wh.detach())
        for n, a, w in zip(("dxi", "dWh", "dh0", "dc0"), auto, written):
            out[p + "autograd_" + n] = a.numpy()
            out[p + "written_" + n] = w.numpy()
    return out


def _flat_tree(tree, prefix):
    """A nested dict of arrays -> {prefix + "a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flax_flat(state_dict, prefix):
    return _flat_tree(mmk.samplernn_params_to_jax(state_dict), prefix)


def _batches(loader, n):
    out = []
    for k, (inputs, targets) in enumerate(loader):
        if k == n:
            break
        out.append((np.asarray(inputs[0]), np.asarray(targets[0])))
    return out


def train_task(inp: dict) -> dict:
    """The training path on the CPU: the JAX-written h5 read by the port's
    Database, a port-written h5, seeded batches (host loader and device
    batcher), cross-entropy, the schedule, three TrainARMLoop steps from the
    JAX weights, and the JAX-written bank decoded by the port."""
    import copy

    from mimikit_tpu_torch.data import h5

    out = {}
    work = str(inp["work"])
    # the JAX-written h5, through the port's Database
    db = mmk.Database(str(inp["jax_h5"]))
    out["jax_h5/signal"] = db.signal[:]
    out["jax_h5/refs"] = np.asarray(db.signal.attrs["refs"])
    out["jax_h5/sources"] = np.array([str(x) for x in db.attrs["sources"]])
    db.close()
    # a port-written h5 of the same source
    port_ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=f"{work}/port.h5",
                                extractors=(mmk.Extractor.signal(16000),))
    port_ds.create(mode="w").close()
    out["h5_backend"] = np.array(h5.backend())

    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))
    db = ds.get(mode="r")
    cfg = mmk.Config.deserialize(str(inp["train_yaml"]))
    cfg.root_dir = f"{work}/port_tr"
    net_cfg = mmk.Config.deserialize(str(inp["net_yaml"]))
    net_cfg.io_spec.bind_to(ds)
    net = mmk.SampleRNN.from_config(net_cfg, device="cpu")
    net.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))

    # seeded batches: the host loader, and the device batcher against it
    host_cfg = copy.deepcopy(cfg)
    host_cfg.trainer_kwargs["device_batching"] = False
    host = _batches(mmk.TrainARMLoop.get_dataloader(db, net, host_cfg), 3)
    dev = _batches(mmk.TrainARMLoop.get_dataloader(db, net, cfg), 3)
    for k, ((hi, ht), (di, dt)) in enumerate(zip(host, dev)):
        out[f"batches/host/{k}/in"], out[f"batches/host/{k}/tgt"] = hi, ht
        out[f"batches/device/{k}/in"], out[f"batches/device/{k}/tgt"] = di, dt

    out["ce"] = mmk.cross_entropy(t(inp["ce_logits"]), t(inp["ce_targets"])).numpy()
    sched = [mmk.onecycle_schedule(int(n), *map(float, rest)) for n, *rest in inp["sched_cfgs"]]
    out["sched"] = np.array([[f(i) for i in range(int(inp["sched_steps"]))] for f in sched])

    # the first step's gradients at the initial weights
    inputs, targets = next(iter(mmk.TrainARMLoop.get_dataloader(db, net, cfg)))
    outputs, _ = net(inputs)
    net.config.io_spec.loss_fn(outputs, targets)["loss"].backward()
    grads = {k: torch.zeros_like(v) for k, v in net.state_dict().items()}
    grads.update({k: p.grad for k, p in net.named_parameters()})
    out.update(_flax_flat(grads, "grads0/"))
    net.zero_grad(set_to_none=True)

    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    loop.run()
    out["losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
    out.update(_flax_flat(net.state_dict(), "params/"))
    out["bias_ih_max"] = np.array(max(float(net.tiers[i].rnn.bias_ih_l0.abs().max())
                                      for i in range(len(net.frame_sizes) - 1)))
    out["port_bank_root"], out["port_bank_id"] = np.array(cfg.root_dir), np.array(loop.hash_)

    # the JAX-written bank, decoded by the port (argmax)
    ck = mmk.Checkpoint(str(inp["jax_bank_id"]), int(inp["jax_bank_epoch"]),
                        str(inp["jax_bank_root"]), device="cpu")
    out["jax_bank_tokens"] = ck.network.generate((inp["prompt"],), int(inp["n_steps"]))[0].numpy()

    # one LSTM bias: a loaded bias_ih is folded into bias_hh, bias_ih is no parameter
    rnn = net.tiers[0].rnn
    sd_ = {k: v.clone() for k, v in rnn.state_dict().items()}
    sd_["bias_ih_l0"] = torch.ones_like(sd_["bias_ih_l0"])
    rnn.load_state_dict(sd_)
    out["bias_fold"] = np.array([
        torch.equal(rnn.bias_hh_l0.detach(), sd_["bias_hh_l0"] + 1),
        float(rnn.bias_ih_l0.abs().max()) == 0.0,
        "bias_ih_l0" not in dict(rnn.named_parameters()),
        "bias_ih_l0" in rnn.state_dict(),
    ])

    # the npz file layer (machines without h5py): a dataset and a bank round trip
    h5py_module, h5.h5py = h5.h5py, None
    npz_db = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=f"{work}/npz.h5",
                               extractors=(mmk.Extractor.signal(16000),)).create(mode="w")
    npz_db.close()
    reread = mmk.DatasetConfig(filename=f"{work}/npz.h5").get(mode="r")
    out["npz/signal"] = reread.signal[:]
    out["npz/refs"] = np.asarray(reread.signal.attrs["refs"])
    mmk.Checkpoint("npz", 1, f"{work}/npz_bank").create(net, trainer_state={"fit_loop": {"epoch": 1}})
    back = mmk.Checkpoint("npz", 1, f"{work}/npz_bank", device="cpu")
    out["npz/bank_equal"] = np.array(all(
        torch.equal(v, net.state_dict()[k]) for k, v in back.network.state_dict().items()
    ))
    out["npz/trainer_state"] = np.array(back.trainer_state["fit_loop"]["epoch"])
    h5.h5py = h5py_module

    # resume: an interrupted run saves epoch=1 (+ .opt); from_checkpoint finishes it
    rcfg = copy.deepcopy(cfg)
    rcfg.root_dir, rcfg.max_epochs, rcfg.save_optimizer = f"{work}/resume", 2, True
    rnet = mmk.SampleRNN.from_config(net_cfg, device="cpu")
    rnet.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))
    first = mmk.TrainARMLoop.from_config(rcfg, db, rnet)

    def stop(*_):
        raise KeyboardInterrupt

    first.on_train_epoch_end = stop
    first.run()
    resumed = mmk.TrainARMLoop.from_checkpoint(
        mmk.Checkpoint(first.hash_, 1, rcfg.root_dir, device="cpu"))
    out["resume/start"] = np.array([resumed.start_epoch, resumed.global_step])
    resumed.run()
    out["resume/end"] = np.array([resumed.global_step, resumed.opt.count])
    out["resume/files"] = np.array(sorted(os.listdir(f"{rcfg.root_dir}/{first.hash_}")))

    # param_dtype: an interrupted bf16 run resumes from its hp.yaml under its policy
    rcfg = copy.deepcopy(cfg)
    rcfg.root_dir, rcfg.max_epochs, rcfg.save_optimizer = f"{work}/resume_bf16", 2, True
    rcfg.trainer_kwargs["param_dtype"] = "bfloat16"
    rnet = mmk.SampleRNN.from_config(net_cfg, device="cpu")
    rnet.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))
    first = mmk.TrainARMLoop.from_config(rcfg, ds.get(mode="r"), rnet)
    first.on_train_epoch_end = stop
    first.run()
    resumed = mmk.TrainARMLoop.from_checkpoint(
        mmk.Checkpoint(first.hash_, 1, rcfg.root_dir, device="cpu"))
    resumed.run()
    out["bf16_resume/policy"] = np.array(str(resumed.half))
    out["bf16_resume/end"] = np.array([resumed.global_step, resumed.opt.count])
    out["bf16_resume/losses"] = np.array([h["loss"] for _, h in resumed.metrics.history])
    out["bf16_resume/dtypes"] = np.array(sorted({str(p.dtype)
                                                 for p in resumed.net.parameters()}))

    # matmul_precision: set for each step, the previous value restored after it
    previous = torch.get_float32_matmul_precision()
    for name in ("float32", "tensorfloat32", "bfloat16"):
        mcfg = copy.deepcopy(cfg)
        mcfg.root_dir, mcfg.max_epochs = f"{work}/matmul_{name}", 1
        mcfg.trainer_kwargs["matmul_precision"] = name
        torch.set_float32_matmul_precision("high")
        mnet = mmk.SampleRNN.from_config(net_cfg, device="cpu")
        seen = []
        mnet.register_forward_pre_hook(lambda *_: seen.append(torch.get_float32_matmul_precision()))
        mmk.TrainARMLoop.from_config(mcfg, ds.get(mode="r"), mnet).run()
        out[f"matmul/{name}"] = np.array(seen + [torch.get_float32_matmul_precision()])
    torch.set_float32_matmul_precision(previous)

    # the TPU dispatch and optimizer-layout knobs change nothing
    for key, value in (("steps_per_dispatch", 4), ("flat_optimizer", True)):
        ncfg = copy.deepcopy(cfg)
        ncfg.root_dir = f"{work}/noop_{key}"
        ncfg.trainer_kwargs[key] = value
        nnet = mmk.SampleRNN.from_config(net_cfg, device="cpu")
        nnet.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))
        nloop = mmk.TrainARMLoop.from_config(ncfg, ds.get(mode="r"), nnet)
        nloop.run()
        out[f"noop/{key}"] = np.array([h["loss"] for _, h in nloop.metrics.history])

    for key, value in (("data_parallel", True), ("n_model", 2), ("fsdp", True)):
        bad = copy.deepcopy(cfg)
        bad.trainer_kwargs[key] = value
        try:
            mmk.TrainARMLoop.from_config(bad, db, net)
            out[f"unported/{key}"] = np.array("ran")
        except NotImplementedError as e:
            out[f"unported/{key}"] = np.array(f"NotImplementedError: {e}")
    return out


def train_stateless_task(inp: dict) -> dict:
    """Three TrainARMLoop steps of each stateless net (WaveNet,
    SimpleTransformer, JukeBox) from the JAX weights, on the JAX-written h5."""
    from_jax = {"wavenet": (mmk.WaveNet, mmk.wavenet_state_dict_from_jax),
                "transformer": (mmk.SimpleTransformer, mmk.transformer_state_dict_from_jax),
                "jukebox": (mmk.JukeBox, mmk.jukebox_state_dict_from_jax)}
    out = {}
    work = str(inp["work"])
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))
    for kind, (cls, to_sd) in from_jax.items():
        db = ds.get(mode="r")
        cfg = mmk.Config.deserialize(str(inp[f"{kind}/train_yaml"]))
        cfg.root_dir = f"{work}/port_{kind}"
        net_cfg = mmk.Config.deserialize(str(inp[f"{kind}/net_yaml"]))
        net_cfg.io_spec.bind_to(ds)
        net = cls.from_config(net_cfg, device="cpu")
        net.load_state_dict(to_sd(unflatten(inp, f"{kind}/params0/")), strict=True)
        loop = mmk.TrainARMLoop.from_config(cfg, db, net)
        loop.run()
        out[f"{kind}/losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
    return out


def bf16_train_stateless_task(inp: dict) -> dict:
    """Three TrainARMLoop steps under ``param_dtype="bfloat16"`` of each
    stateless net of ``inp`` from the JAX weights, and a control (WaveNet's
    conv bias inside the product, one rounding for both; the transformers'
    bf16 softmax differentiated by PyTorch's autograd); the transformers'
    layer norm with ``torch.rsqrt``, and JukeBox's with a row's 16 partial
    sums added in order."""
    from mimikit_tpu_torch.networks import wavenet as wn

    from_jax = {"wavenet": (mmk.WaveNet, mmk.wavenet_state_dict_from_jax),
                "transformer": (mmk.SimpleTransformer, mmk.transformer_state_dict_from_jax),
                "jukebox": (mmk.JukeBox, mmk.jukebox_state_dict_from_jax)}
    work = str(inp["work"])
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))

    def losses(kind, tag):
        cls, to_sd = from_jax[kind]
        db = ds.get(mode="r")
        cfg = mmk.Config.deserialize(str(inp[f"{kind}/train_yaml"]))
        cfg.root_dir = f"{work}/port_{kind}_{tag}"
        net_cfg = mmk.Config.deserialize(str(inp[f"{kind}/net_yaml"]))
        net_cfg.io_spec.bind_to(ds)
        net = cls.from_config(net_cfg, device="cpu")
        net.load_state_dict(to_sd(unflatten(inp, f"{kind}/params0/")), strict=True)
        loop = mmk.TrainARMLoop.from_config(cfg, db, net)
        loop.run()
        return np.array([h["loss"] for _, h in loop.metrics.history])

    out = {}
    kinds = sorted({k.split("/")[0] for k in inp if k.endswith("/net_yaml")})
    for kind in kinds:
        out[f"{kind}/losses"] = losses(kind, "bf16")
    fixed = wn._conv
    wn._conv = lambda conv, x: conv(x.transpose(1, 2)).transpose(1, 2)
    try:
        for kind in [k for k in kinds if k == "wavenet"]:
            out[f"{kind}/control_losses"] = losses(kind, "control")
    finally:
        wn._conv = fixed
    # the transformers' control: the bf16 softmax differentiated by autograd
    from mimikit_tpu_torch.modules import rounding

    fixed = rounding.softmax
    rounding.softmax = lambda x: (lambda e: e / e.sum(-1, keepdim=True))(
        torch.exp(x - x.amax(-1, keepdim=True)))
    try:
        for kind in [k for k in kinds if k in ("transformer", "jukebox")]:
            out[f"{kind}/control_losses"] = losses(kind, "control")
    finally:
        rounding.softmax = fixed
    # the layer norm's rsqrt as torch.rsqrt computes it, not as XLA's CPU code
    fixed = rounding.xla_rsqrt
    rounding.xla_rsqrt = torch.rsqrt
    try:
        for kind in [k for k in kinds if k in ("transformer", "jukebox")]:
            out[f"{kind}/rsqrt_control_losses"] = losses(kind, "rsqrt_control")
    finally:
        rounding.xla_rsqrt = fixed
    # a row's 16 partial sums added in order, not as XLA's two registers
    fixed = rounding._row_sum

    def in_order(x):
        if x.shape[-1] > 32:
            return fixed(x)
        out = sum_ = None
        for lane in range(min(16, x.shape[-1])):
            part = x[..., lane::16]
            sum_ = part[..., 0]
            for i in range(1, part.shape[-1]):
                sum_ = sum_ + part[..., i]
            out = sum_ if out is None else out + sum_
        return out

    rounding._row_sum = in_order
    try:
        for kind in [k for k in kinds if k == "jukebox"]:
            out[f"{kind}/row_sum_control_losses"] = losses(kind, "row_sum_control")
    finally:
        rounding._row_sum = fixed
    return out


def lstm_plan_task(inp: dict) -> dict:
    """The fused LSTM kernels' plans at each case of ``inp["cases"]`` (B, H,
    element bytes, forced cluster size or 0): the forward's and the
    backward's (cluster size, rows), or the error each raises, and the shared
    memory each plan asks; the route tables; and the shared memory the
    wrapper computes for each (H, rows, cluster size, element bytes) of
    ``inp["smem_grid"]`` (the forward's and the backward's)."""
    from mimikit_tpu_torch.ops import fused_lstm as fl

    out = {"sizes": np.array(fl.BWD_CLUSTER_SIZES), "fwd_sizes": np.array(fl.FWD_CLUSTER_SIZES),
           "smem_limit": np.array(fl.SMEM_PER_BLOCK)}
    for name, route in (("route", fl.LSTM_BWD_ROUTE), ("fwd_route", fl.LSTM_FWD_ROUTE)):
        for dt, (cl, most) in route.items():
            out[f"{name}/{str(dt).split('.')[-1]}"] = np.array([cl, most])
    for B, H, es, cl in inp["cases"].tolist():
        key = f"b{B}_h{H}_e{es}_cl{cl}"
        for part, plan, smem in (("fwd", fl.lstm_fwd_plan, fl._fwd_smem),
                                 ("bwd", fl.lstm_bwd_plan, fl._bwd_smem)):
            try:
                size, rows = plan(B, H, es, cl or None)
                out[f"{key}/{part}_plan"] = np.array([size, rows])
                out[f"{key}/{part}_smem"] = np.array(smem(H, rows, size, es))
            except ValueError as e:
                out[f"{key}/{part}_error"] = np.array(str(e))
    out["smem_grid"] = np.array([[H, r, cl, es, fl._fwd_smem(H, r, cl, es), fl._bwd_smem(H, r, cl, es)]
                                 for H, r, cl, es in inp["smem_grid"].tolist()])
    return out


def xla_rsqrt_task(inp: dict) -> dict:
    """The port's CPU rsqrt (``modules/xla_cpu_rsqrt``) and, as a control,
    ``torch.rsqrt`` of each input array, and of every prefix of ``x`` up to
    ``n_prefix`` long (the instruction's vector loop and its tail)."""
    from mimikit_tpu_torch.modules.xla_cpu_rsqrt import xla_rsqrt

    out = {}
    for k in ("x", "edges"):
        x = torch.from_numpy(inp[k])
        out[f"port/{k}"] = xla_rsqrt(x).numpy()
        out[f"torch/{k}"] = torch.rsqrt(x).numpy()
    try:
        xla_rsqrt(torch.ones(4, dtype=torch.bfloat16))
        out["refuses_bf16"] = np.array(False)
    except ValueError:
        out["refuses_bf16"] = np.array(True)
    x = torch.from_numpy(inp["x"])
    out["prefixes"] = np.concatenate([xla_rsqrt(x[:n].clone()).numpy()
                                      for n in range(1, int(inp["n_prefix"]) + 1)])
    return out


def load_wavenet(inp: dict, p: str):
    """The port's WaveNet from the JAX-written YAML, with the JAX weights."""
    cfg = mmk.Config.deserialize(str(inp[p + "yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    net = mmk.WaveNet.from_config(cfg, device="cpu").eval()
    sd_ = mmk.wavenet_state_dict_from_jax(unflatten(inp, p + "params/"))
    net.load_state_dict(sd_, strict=True)
    return net, sd_


def wavenet_task(inp: dict) -> dict:
    """Per net: train-mode forward, eval samples, the gate, argmax generate
    through both kernel wrappers (decode_chunk over several chunks), a short
    prompt, argmax and sampled streams, the weight maps; per layer case, the
    layer's outputs; the rf contract; a port-written bank."""
    from mimikit_tpu_torch.networks.wavenet import WNLayer
    from mimikit_tpu_torch.ops import wavenet_decode as wd

    # tiny tensors: one thread; a pool of them spins against the other test
    # processes of a parallel run and slows this task twentyfold
    torch.set_num_threads(1)
    out = {}
    n = int(inp["n_steps"])
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
        p = f"{tag}/"
        net, sd_ = load_wavenet(inp, p)
        out.update({f"{p}sd/{k}": v.numpy() for k, v in sd_.items()})
        out.update(_flat_tree(mmk.wavenet_params_to_jax(net.state_dict()), p + "back/"))
        with torch.no_grad():
            out[p + "forward"] = net.train()((t(inp[p + "seq"]),))[0].numpy()
            out[p + "eval"] = net.eval()((t(inp[p + "seq"]),))[0].numpy()
        out[p + "in_gate"] = np.array(wd.supports_kernel_decode(net))
        prompt = inp[p + "prompt"]
        out[p + "generate"] = net.generate((prompt,), n)[0].numpy()
        out[p + "short"] = net.generate((inp[p + "short_prompt"],), n)[0].numpy()
        stream = mmk.stream_tokens(net, (prompt,), 7)
        out[p + "stream"] = np.concatenate([next(stream) for _ in range(n // 7)], 1)
        stream.close()
        net._CHUNKED_MIN_B, net._CHUNK = 1, 16  # decode_chunk over several chunks
        out[p + "generate_chunked"] = net.generate((prompt,), n)[0].numpy()
        sampled = net.generate((prompt,), n, temperature=0.9, seed=5)[0].numpy()
        out[p + "sampled"] = sampled
        for c in (9, 13):
            stream = mmk.stream_tokens(net, (prompt,), c, temperature=0.9, seed=5)
            out[f"{p}sampled_stream_{c}"] = np.concatenate([next(stream) for _ in range(n // c)], 1)
            stream.close()
        net.eval().before_generate((prompt,), 0)
        steps = [net.generate_step((t(prompt[:, : k + 1]),), t=k + 1) for k in range(net.rf, net.rf + 4)]
        out[p + "generate_step"] = np.stack([s_[0].numpy() for s_ in steps], 1)
        net.after_generate(steps[-1], 0)
    if "bank_root" in inp:
        net, _ = load_wavenet(inp, "net_b3/")
        root = str(inp["bank_root"])
        ck = mmk.Checkpoint("wn_jax", 1, root, device="cpu")
        out["bank/jax_tokens"] = ck.network.generate((inp["net_b3/prompt"],), n)[0].numpy()
        out["bank/jax_type"] = np.array(type(ck.network).__name__)
        mmk.Checkpoint("wn_port", 1, root).create(net)

    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("layer_")}):
        p = f"{tag}/"
        kw = json.loads(str(inp[p + "kwargs"]))
        layer = WNLayer(**kw)
        sd_ = mmk.wavenet_state_dict_from_jax({"layer0": unflatten(inp, p + "params/")})
        layer.load_state_dict({k[len("layers.0."):]: v for k, v in sd_.items()}, strict=True)
        skips = t(inp[p + "skips"]) if p + "skips" in inp else None
        ins_1x1 = tuple(t(inp[f"{p}x1x1_{i}"]) for i in range(len(kw.get("dims_1x1", ()))))
        with torch.no_grad():
            y, sk = layer((t(inp[p + "x"]),), ins_1x1, skips)
        out[p + "y"] = y.numpy()
        if sk is not None:
            out[p + "skips"] = sk.numpy()

    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16,
                                                      input_module_type="embedding"))
    rf_nets = []
    for blocks in inp["rf_blocks"]:
        cfg = mmk.WaveNet.Config(io_spec=io, blocks=tuple(int(b) for b in blocks if b),
                                 dims_dilated=(16,))
        net = mmk.WaveNet.from_config(cfg, device="cpu")
        rf = net.rf
        lens = []
        with torch.no_grad():
            for T in (rf, rf + 1):
                lens.append(net.train()((torch.zeros(2, T, dtype=torch.long),))[0].shape[1])
        try:
            net((torch.zeros(2, rf - 1, dtype=torch.long),))
            raised = "ran"
        except RuntimeError:
            raised = "RuntimeError"
        rf_nets.append([str(rf), *map(str, lens), raised])
    out["rf"] = np.array(rf_nets)
    return out


def categorical_task(inp: dict) -> dict:
    """The K9 plain twin (CPU tensors), the sampler's routes and the
    sampler_impl round trip."""
    from mimikit_tpu_torch.ops import categorical as cat

    torch.set_num_threads(1)  # as wavenet_task
    out = {}
    x = t(inp["ragged"])
    out["ragged"] = cat.categorical(x, 1.0, 3).numpy()
    sharp = t(inp["sharp"])
    out["cold"] = cat.categorical(sharp, 0.01, 4).numpy()
    out["same_a"] = cat.categorical(x, 0.7, 11).numpy()
    out["same_b"] = cat.categorical(x, 0.7, 11).numpy()
    out["other"] = cat.categorical(x, 0.7, 12).numpy()
    rows = t(inp["chi_logits"]).expand(int(inp["chi_n"]), -1).contiguous()
    out["chi_draws"] = cat.categorical(rows, float(inp["chi_t"]), 21).numpy()
    out["launches"] = np.array(cat.categorical.launches)

    sampler = mmk.CategoricalSampler(impl="pallas")
    g = torch.Generator().manual_seed(8)
    via = sampler(x, temperature=0.7, generator=g).numpy()
    seed = int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(8)))
    out["sampler_pallas"] = via
    out["sampler_pallas_ref"] = cat.categorical_plain(x, 0.7, seed).numpy()
    out["sampler_tuple"] = sampler(x[:, 0], temperature=(0.5, 0.7, 0.9),
                                   generator=torch.Generator().manual_seed(8)).numpy()

    for impl in ("jax", "pallas"):
        io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(sampler_impl=impl))
        out[f"io/{impl}/params"] = np.array(json.dumps(io.targets[0].objective.params))
        out[f"io/{impl}/yaml"] = np.array(io.serialize())
        jax_io = mmk.Config.deserialize(str(inp[f"io/{impl}/yaml"]), as_type=mmk.IOSpec)
        out[f"io/{impl}/loaded_impl"] = np.array(jax_io.targets[0].objective.get_sampler().impl)
    return out


def load_transformer(inp: dict, p: str):
    """The port's SimpleTransformer from the JAX-written YAML, with the JAX
    weights."""
    cfg = mmk.Config.deserialize(str(inp[p + "yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    net = mmk.SimpleTransformer.from_config(cfg, device="cpu").eval()
    sd_ = mmk.transformer_state_dict_from_jax(unflatten(inp, p + "params/"))
    net.load_state_dict(sd_, strict=True)
    return net, sd_


@contextlib.contextmanager
def _counting(module, name):
    """Count the calls of ``module.name`` inside the block: yields a one-item
    list that holds the count."""
    fn, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _stream(net, prompt, chunk, n_chunks, **kw):
    it = mmk.stream_tokens(net, (prompt,), chunk, **kw)
    out = np.concatenate([next(it) for _ in range(n_chunks)], 1)
    it.close()
    return out


def transformer_task(inp: dict) -> dict:
    """Per net: the forward in both modes, the gate, argmax generate through
    each route (K6's twin at B=1 and 2, the batched window route called at
    B=2 and taken past ``_K6_MAX_BATCH`` streams, the K6 wrapper at B=2, the
    KV-cached decoder for a short prompt), KV streams (argmax over two
    chunkings and sampled), sampled generate and re-feed streams, the weight
    maps; the pre-norm stacks; the gate on a SampleRNN and on two nets built
    from their YAML; the banks."""
    from mimikit_tpu_torch.networks import transformers as tf_net
    from mimikit_tpu_torch.networks.transformers import DecoderStack
    from mimikit_tpu_torch.ops import transformer_decode as td

    torch.set_num_threads(1)  # as wavenet_task
    out = {}
    n = int(inp["n_steps"])
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
        p = f"{tag}/"
        net, sd_ = load_transformer(inp, p)
        rf = net.rf
        out.update({f"{p}sd/{k}": v.numpy() for k, v in sd_.items()})
        out.update(_flat_tree(mmk.transformer_params_to_jax(net.state_dict(), net.config.n_heads),
                              p + "back/"))
        out[p + "state_dict_keys"] = np.array(sorted(net.state_dict()))
        with torch.no_grad():
            out[p + "forward"] = net.train()((t(inp[p + "seq"]),))[0].numpy()
            out[p + "eval"] = net.eval()((t(inp[p + "seq"]),))[0].numpy()
        in_gate = td.supports_kernel_decode(net)
        out[p + "in_gate"] = np.array(in_gate)
        p1, p2, kvp = inp[p + "prompt1"], inp[p + "prompt2"], inp[p + "kv_prompt"]
        launches = td.decode_window.launches
        out[p + "generate_b1"] = net.generate((p1,), n)[0].numpy()
        with _counting(tf_net, "decode_window") as calls:
            out[p + "generate_b2"] = net.generate((p2,), n)[0].numpy()
        out[p + "generate_b2_window_calls"] = np.array(calls[0])
        out[p + "window_route_b2"] = net._window_loop(t(p2), n, None, 0).numpy()
        with _counting(tf_net, "decode_window") as calls:
            out[p + "generate_wide_b"] = net.generate((inp[p + "prompt_wide_b"],), n)[0].numpy()
        out[p + "generate_wide_b_window_calls"] = np.array(calls[0])
        out[p + "short"] = net.generate((inp[p + "short"],), n)[0].numpy()
        out[p + "window_first"] = net.generate((kvp,), 1)[0][:, rf].numpy()
        if not in_gate:
            continue
        out[p + "launches_on_cpu"] = np.array(td.decode_window.launches - launches)
        pack = td.transformer_weight_pack(net)
        out[p + "window_b2"] = td.decode_window(pack, t(p2), n, 0, None).numpy()
        os.environ["MMK_DECODE_KV"] = "1"
        try:
            for B in (1, 2):
                out[f"{p}kv_b{B}_c7"] = _stream(net, kvp[:B], 7, 10)
                out[f"{p}kv_b{B}_c9"] = _stream(net, kvp[:B], 9, 8)
            for c, k in ((7, 10), (9, 8)):
                out[f"{p}kv_sampled_c{c}"] = _stream(net, kvp, c, k, temperature=0.9, seed=5)
        finally:
            del os.environ["MMK_DECODE_KV"]
        out[p + "sampled_a"] = net.generate((p1,), n, temperature=0.9, seed=5)[0].numpy()
        out[p + "sampled_b"] = net.generate((p1,), n, temperature=0.9, seed=5)[0].numpy()
        with _counting(tf_net, "transformer_weight_pack") as packs:
            out[p + "refeed"] = _stream(net, p1, 9, 3, temperature=0.9, seed=5)
        out[p + "refeed_packs"] = np.array(packs[0])
        seeds, buf, chunks = torch.Generator().manual_seed(5), t(p1), []
        for _ in range(3):
            sub = int(torch.randint(0, 2**31 - 1, (1,), generator=seeds))
            full = net.generate((buf,), 9, temperature=0.9, seed=sub)[0]
            chunks.append(full[:, buf.shape[1]:].numpy())
            buf = full[:, -net._window_len():]
        out[p + "refeed_generates"] = np.concatenate(chunks, 1)

    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("stack_")}):
        p = f"{tag}/"
        d, nh, ff, L, fln = (int(v) for v in inp[p + "dims"])
        stack = DecoderStack(d, nh, ff, L, norm_first=True, with_layer_norm=bool(fln))
        sd_ = mmk.transformer_state_dict_from_jax({"model": unflatten(inp, p + "params/")})
        stack.load_state_dict({k[len("model."):]: v for k, v in sd_.items()}, strict=True)
        with torch.no_grad():
            out[p + "y"] = stack.eval()(t(inp[p + "x"])).numpy()

    out["k6_max_batch"] = np.array(mmk.SimpleTransformer._K6_MAX_BATCH)
    for tag in ("long", "wide"):  # the gate on nets built from their YAML, no weights needed
        cfg = mmk.Config.deserialize(str(inp[f"{tag}/yaml"]))
        cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[f"{tag}/in_gate"] = np.array(td.supports_kernel_decode(
                mmk.SimpleTransformer.from_config(cfg, device="cpu")))
        out[f"{tag}/warnings"] = np.array([str(w.message) for w in caught], dtype=str)

    srnn_cfg = mmk.Config.deserialize(str(inp["srnn_yaml"]))
    srnn_cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    out["srnn_in_gate"] = np.array(
        td.supports_kernel_decode(mmk.SampleRNN.from_config(srnn_cfg, device="cpu")))

    net, _ = load_transformer(inp, "net_h4/")
    root = str(inp["bank_root"])
    ck = mmk.Checkpoint("tf_jax", 1, root, device="cpu")
    out["bank/jax_tokens"] = ck.network.generate((inp["net_h4/prompt1"],), n)[0].numpy()
    out["bank/jax_type"] = np.array(type(ck.network).__name__)
    mmk.Checkpoint("tf_port", 1, root).create(net)
    return out


def load_jukebox(inp: dict, p: str):
    """The port's JukeBox from the JAX-written YAML, with the JAX weights."""
    cfg = mmk.Config.deserialize(str(inp[p + "yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    net = mmk.JukeBox.from_config(cfg, device="cpu").eval()
    sd_ = mmk.jukebox_state_dict_from_jax(unflatten(inp, p + "params/"))
    net.load_state_dict(sd_, strict=True)
    return net, sd_


def jukebox_task(inp: dict) -> dict:
    """Per net: the train forward, the eval forward's blindness to the last
    token, the gate, argmax generate at B = 1, 2, 4 and for a short and a
    long prompt, the window route, generate_step, streams (argmax; sampled
    over two chunkings), the weight maps, the YAML; the refused and unported
    variants; the rf-12 re-feed stream; the banks."""
    from mimikit_tpu_torch.loops.streaming import _refeed_stream
    from mimikit_tpu_torch.ops import jukebox_decode as jbd

    torch.set_num_threads(1)  # as wavenet_task
    out = {}
    n = int(inp["n_steps"])
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
        p = f"{tag}/"
        net, sd_ = load_jukebox(inp, p)
        W = net._window_len()
        out[p + "yaml_back"] = np.array(net.config.serialize())
        out.update({f"{p}sd/{k}": v.numpy() for k, v in sd_.items()})
        out.update(_flat_tree(mmk.jukebox_params_to_jax(net.state_dict(), net.config.n_heads),
                              p + "back/"))
        out[p + "state_dict_keys"] = np.array(sorted(net.state_dict()))
        seq = t(inp[p + "seq"])
        changed = seq.clone()
        changed[:, -1] = (changed[:, -1] + 7) % net.config.io_spec.inputs[0].elem_type.size
        with torch.no_grad():
            out[p + "forward"] = net.train()((seq,))[0].numpy()
            out[p + "eval"] = net.eval()((seq,))[0].numpy()
            out[p + "eval_last_changed"] = net((changed,))[0].numpy()
        in_gate = jbd.supports_kernel_decode(net)
        out[p + "in_gate"] = np.array(in_gate)
        launches = jbd.decode_pyramid.launches
        for B in (1, 2, 4):
            out[f"{p}generate_b{B}"] = net.generate((inp[f"{p}prompt{B}"],), n)[0].numpy()
        out[p + "short"] = net.generate((inp[p + "short"],), n)[0].numpy()
        out[p + "long"] = net.generate((inp[p + "long"],), n)[0].numpy()
        out[p + "launches_on_cpu"] = np.array(jbd.decode_pyramid.launches - launches)
        full = t(out[p + "generate_b2"])
        out[p + "generate_step"] = np.stack(
            [net.generate_step((full[:, k - W : k],), t=k)[0].reshape(-1).numpy()
             for k in range(W, W + 8)], 1)
        p2 = inp[p + "prompt2"]
        out[p + "stream_b2"] = _stream(net, p2, 8, 3)
        if not in_gate:
            continue
        out[p + "window_loop_b2"] = net._window_loop(t(p2), n, None, 0).numpy()
        out[p + "stream_b1"] = _stream(net, inp[p + "prompt1"], 8, 3)
        out[p + "sampled_a"] = net.generate((p2,), n, temperature=0.9, seed=5)[0].numpy()
        out[p + "sampled_b"] = net.generate((p2,), n, temperature=0.9, seed=5)[0].numpy()
        out[p + "sampled_c7"] = _stream(net, p2, 7, 3, temperature=0.9, seed=5)
        out[p + "sampled_c9"] = _stream(net, p2, 9, 3, temperature=0.9, seed=5)

    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("refused_")}):
        cfg = mmk.Config.deserialize(str(inp[f"{tag}/yaml"]))
        cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
        flip = cfg.ref_compat  # the port builds no ref_compat net: the flag is set afterwards
        cfg.ref_compat = False
        net = mmk.JukeBox.from_config(cfg, device="cpu")
        net.config.ref_compat = flip
        out[f"{tag}/in_gate"] = np.array(jbd.supports_kernel_decode(net))

    cfg = mmk.Config.deserialize(str(inp["wide/yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    wide = mmk.JukeBox.from_config(cfg, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["wide/in_gate"] = np.array(jbd.supports_kernel_decode(wide))
    out["wide/warnings"] = np.array([str(w.message) for w in caught], dtype=str)

    base = mmk.Config.deserialize(str(inp["net_f842/yaml"]))
    base.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    emb = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16,
                                                       input_module_type="embedding"))
    for what, cfg in (("ref_compat", dict(ref_compat=True)), ("weight_norm", dict(weight_norm=True)),
                      ("embedding", dict(io_spec=emb))):
        variant = copy.deepcopy(base)
        for k, v in cfg.items():
            setattr(variant, k, v)
        try:
            mmk.JukeBox.from_config(variant, device="cpu")
            out[f"unported/{what}"] = np.array("ran")
        except NotImplementedError as e:
            out[f"unported/{what}"] = np.array(f"NotImplementedError: {e}")

    net, _ = load_jukebox(inp, "rf12/")
    prompt = t(inp["rf12/prompt"])
    it = _refeed_stream(net, prompt, 8, None, 0)
    out["rf12/refeed"] = np.concatenate([next(it) for _ in range(4)], 1)
    it.close()
    buf, chunks = prompt, []
    for _ in range(4):  # re-feeding rf + 1 tokens instead of the window
        full = net.generate((buf,), 8)[0]
        chunks.append(full[:, buf.shape[1]:].numpy())
        buf = full[:, -(net.rf + 1):]
    out["rf12/refeed_rf1"] = np.concatenate(chunks, 1)

    net, _ = load_jukebox(inp, "net_f842/")
    root = str(inp["bank_root"])
    ck = mmk.Checkpoint("jb_jax", 1, root, device="cpu")
    out["bank/jax_tokens"] = ck.network.generate((inp["net_f842/prompt1"],), n)[0].numpy()
    out["bank/jax_type"] = np.array(type(ck.network).__name__)
    mmk.Checkpoint("jb_port", 1, root).create(net)
    return out


def _jukebox_plan_data(out: dict, q: str, pack, plan, cw, tabs) -> None:
    """A K8 residency plan's numbers and its relayout's checks under ``q``."""
    from mimikit_tpu_torch.ops import jukebox_decode as jbd

    cl = plan.cl
    flat = pack.flat.numpy()
    cw, tabs = cw.numpy(), tabs.numpy()
    out[q + "fits"] = np.array(plan.fits)
    out[q + "smem_bytes"] = np.array(plan.smem_bytes)
    out[q + "act_floats"] = np.array(plan.act_floats)
    out[q + "wreg_floats"] = np.array(plan.wreg_floats)
    out[q + "tabs"] = tabs
    out[q + "resident_bytes"] = np.array([plan.bytes(r, True) for r in range(cl)])
    out[q + "streamed_bytes"] = np.array([plan.bytes(r, False) for r in range(cl)])
    out[q + "piece_bytes"] = np.array(
        [4 * sum(nq * 4 * plan.units[u].K for u, _, nq in plan.pieces(r)) for r in range(cl)])
    out[q + "small_floats"] = np.array(plan.small)
    out[q + "units"] = np.array([u.name for u in plan.units])
    out[q + "unit_K"] = np.array([u.K for u in plan.units])
    heads = [jbd._heads(pack.n_heads, cl, r) for r in range(cl)]
    out[q + "heads"] = np.array(heads)
    ok_slices = []
    for u, unit in enumerate(plan.units):
        full = flat[pack.offsets[unit.src][0]:][: unit.K * unit.N].reshape(unit.K, unit.N)
        out[f"{q}cols/{unit.name}"] = np.array(
            [c for r in range(cl) for c in unit.cols[r]] or [-1])
        out[f"{q}cols_of/{unit.name}"] = np.array([len(unit.cols[r]) for r in range(cl)])
        good = True
        for r in range(cl):
            tab = tabs[r]
            base, n_units = tab[0], tab[3]
            wofs, bofs, nq = tab[4 + 3 * u : 7 + 3 * u]
            want = full[:, list(unit.cols[r])]
            if nq * 4 != len(unit.cols[r]):
                good = False
                continue
            if wofs >= 0:
                got = cw[base + wofs : base + wofs + unit.K * 4 * nq].reshape(unit.K, -1)
            else:  # its pieces, each k-major over its quads, side by side
                got = []
                for i, (uu, _, pq) in enumerate(plan.pieces(r)):
                    if uu == u:
                        g, fl = tab[4 + 3 * n_units + 2 * i : 6 + 3 * n_units + 2 * i]
                        got.append(cw[base + g : base + g + fl].reshape(unit.K, 4 * pq))
                got = np.concatenate(got, 1) if got else np.zeros((unit.K, 0), np.float32)
            bias = flat[pack.offsets[unit.bias][0] + np.asarray(unit.cols[r], int)] \
                if len(unit.cols[r]) else np.zeros(0, np.float32)
            good &= np.array_equal(got, want) and np.array_equal(
                cw[base + bofs : base + bofs + len(unit.cols[r])], bias)
        ok_slices.append(good)
    out[q + "slices_equal_pack"] = np.array(ok_slices)


def jukebox_cluster_task(inp: dict) -> dict:
    """The cluster kernel's residency plan and relayout at each net's widths
    and cluster size, the group kernel's at each cluster size and group size
    (1, 2 and the most that fit), and ``decode_pyramid``'s route by B (the
    launchers replaced by recorders, the window on the meta device so that
    the route is taken without a card), directly over chunks of several
    lengths and inside a JukeBox stream on the CPU."""
    from mimikit_tpu_torch.ops import jukebox_decode as jbd

    torch.set_num_threads(1)
    out = {"limit": np.array(jbd._K8_CLUSTER_MAX_B), "sizes": np.array(jbd.CLUSTER_SIZES),
           "route": np.array(jbd.K8_CLUSTER_ROUTE), "group_sizes": np.array(jbd.GROUP_SIZES),
           "group_route": np.array(jbd.K8_GROUP_ROUTE)}
    taken = []

    def block(pack, window, t0, n_steps, seed, temperature):
        taken.append("block")
        return torch.zeros(window.shape[0], n_steps, dtype=torch.int32, device=window.device)

    def cluster(pack, window, t0, n_steps, seed, temperature, cl=None):
        taken.append(f"cluster{cl}")
        return torch.zeros(window.shape[0], n_steps, dtype=torch.int32, device=window.device)

    def group(pack, window, t0, n_steps, seed, temperature, cl, S=None):
        taken.append(f"group{cl}")
        return torch.zeros(window.shape[0], n_steps, dtype=torch.int32, device=window.device)

    jbd._launch, jbd._launch_cluster, jbd._launch_group = block, cluster, group
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
        p = f"{tag}/"
        spec = json.loads(str(inp[p + "spec"]))
        io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=spec.pop("q_levels"),
                                                          mlp_dim=spec.pop("mlp_dim")))
        net = mmk.JukeBox.from_config(mmk.JukeBox.Config(io_spec=io, input_dropout=0.0, **spec),
                                      device="cpu", seed=3).eval()
        pack = jbd.jukebox_weight_pack(net)
        out[p + "in_gate"] = np.array(jbd.supports_kernel_decode(net))
        # the weights a step reads (matrices only), for the plan's coverage
        used = 0
        for k, (o, shape) in pack.offsets.items():
            if len(shape) == 2 and not k.startswith("pe."):
                used += int(np.prod(shape))
        t_last, n_up = pack.t_up[-1], pack.n_up
        used -= pack.dim * (t_last - 1) * pack.dim  # the bottom reads the last chunk only
        out[p + "step_weights"] = np.array(used)
        for cl in jbd.CLUSTER_SIZES:
            plan = jbd.cluster_plan(pack, cl)
            if plan.fits:
                cw, tabs, _ = jbd.cluster_layout(pack, cl)
                _jukebox_plan_data(out, f"{p}cl{cl}/", pack, plan, cw, tabs)
            else:
                out[f"{p}cl{cl}/fits"] = np.array(False)
        for cl in jbd.GROUP_SIZES:
            S_max = jbd.max_streams(pack, cl)
            out[f"{p}g{cl}/max_streams"] = np.array(S_max)
            out[f"{p}g{cl}/groups"] = np.array(sorted({S for S in (1, 2, S_max) if S <= S_max}))
            out[f"{p}g{cl}/smem_by_S"] = np.array(
                [jbd.group_plan(pack, cl, S).smem_bytes for S in range(1, S_max + 2)])
            out[f"{p}g{cl}/act_by_S"] = np.array(
                [jbd.group_plan(pack, cl, S).act_floats for S in range(1, S_max + 2)])
            for S in sorted({S for S in (1, 2, S_max) if 1 <= S <= S_max}):
                plan = jbd.group_plan(pack, cl, S)
                cw, tabs, _ = jbd.group_layout(pack, cl, S)
                _jukebox_plan_data(out, f"{p}g{cl}s{S}/", pack, plan, cw, tabs)
        routes = jbd.K8_CLUSTER_ROUTE + jbd.K8_GROUP_ROUTE
        for B in sorted({1, 2, 60, 61, 64, 200} | {b + e for b, _ in routes for e in (0, 1)}):
            taken.clear()
            window = torch.zeros(B, pack.window, dtype=torch.int32, device="meta")
            for n in (7, 64, 1600):  # chunks of several lengths
                jbd.decode_pyramid(pack, window, pack.window, n, 0, None)
            out[f"{p}route_b{B}"] = np.array(taken)
    # a JukeBox stream on the CPU, each chunk's window also sent through the route
    spec = json.loads(str(inp[f"net_{inp['stream_net']}/spec"]))
    io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=spec.pop("q_levels"),
                                                      mlp_dim=spec.pop("mlp_dim")))
    net = mmk.JukeBox.from_config(mmk.JukeBox.Config(io_spec=io, input_dropout=0.0, **spec),
                                  device="cpu", seed=3).eval()
    real = jbd.decode_pyramid

    def routed(pack, window, t0, n_steps, seed, temperature):
        real(pack, torch.empty(window.shape, dtype=window.dtype, device="meta"), t0, n_steps,
             seed, temperature)
        return real(pack, window, t0, n_steps, seed, temperature)

    jbd.decode_pyramid = routed
    for B in (1, 8, 16, 17):
        taken.clear()
        prompt = torch.randint(0, 32, (B, net._window_len()), generator=torch.Generator().manual_seed(B))
        out[f"stream_b{B}"] = _stream(net, prompt, 8, 3)
        out[f"stream_route_b{B}"] = np.array(taken)
    jbd.decode_pyramid = real
    return out


def samplernn_cluster_task(inp: dict) -> dict:
    """The SampleRNN cluster kernel's plan and relayout at each net's widths,
    cluster size, dtype and group size, and ``decode_chunk``'s route by B
    (the launchers replaced by recorders, the tensors on the meta device so
    that the route is taken without a card), directly over chunks of
    several lengths and inside a SampleRNN stream on the CPU."""
    torch.set_num_threads(1)
    out = {f"route/{str(dt).split('.')[-1]}": np.array([[most, cl or 0] for most, cl in route])
           for dt, route in sd.K2_CLUSTER_ROUTE.items()}
    out["sizes"] = np.array(sd.CLUSTER_SIZES)
    taken = []

    def block(pack, prompt, state, t0, n, o, out_t0, seed, temp, group=None):
        taken.append("block")
        return True

    def cluster(pack, prompt, state, t0, n, o, out_t0, seed, temp, cl, counts):
        taken.append(f"cluster{cl}")
        return True

    real = sd._launch, sd._launch_cluster
    sd._launch, sd._launch_cluster = block, cluster
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
        spec = json.loads(str(inp[f"{tag}/spec"]))
        io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=spec["q_levels"],
                                                          mlp_dim=spec["mlp_dim"]))
        net = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
            frame_sizes=tuple(spec["frame_sizes"]), hidden_dim=spec["hidden_dim"], io_spec=io),
            device="cpu", seed=3).eval()
        for dn, dt in dtypes.items():
            pack = sd.samplernn_weight_pack(net, dt)
            for cl in sd.CLUSTER_SIZES:
                q = f"{tag}/{dn}/cl{cl}/"
                S_max = sd.max_streams(pack, cl)
                out[q + "max_streams"] = np.array(S_max)
                if not S_max:
                    continue
                groups = sorted({1, S_max, *[min(S_max, -(-256 // c)) for c in (7, 8, 15, 16)]})
                out[q + "groups"] = np.array(groups)
                out[q + "smem"] = np.array([sd.cluster_plan(pack, cl, S).smem_bytes for S in groups])
                out[q + "slots"] = np.array([sd.cluster_plan(pack, cl, S).n_slots for S in groups])
                plan = sd.cluster_plan(pack, cl, S_max)
                cw = sd.cluster_layout(pack, cl).float().numpy().reshape(cl, plan.region)
                esize = pack.flat.element_size()
                out[q + "esize"] = np.array(esize)
                out[q + "offsets_bytes"] = np.array([o * esize for o in plan.offsets.values()]
                                                    + [plan.region * esize,
                                                       plan.n_resident * esize])
                pieces = []
                for u, unit in enumerate(plan.units):
                    if not unit.resident:
                        nb = len(unit.cols[0])
                        pieces += [(plan.offsets[unit.src] + k0 * nb) * esize
                                   for k0, _ in plan.pieces(u)]
                        pieces += [rows * nb * esize for _, rows in plan.pieces(u)]
                out[q + "piece_bytes"] = np.array(pieces)
                # each unit: the ranks' columns, and the relaid slices against the pack's
                for unit in plan.units:
                    cols = [list(c) for c in unit.cols]
                    out[f"{q}cols/{unit.name}"] = np.array(cols)
                    out[f"{q}N/{unit.name}"] = np.array(unit.N)
                    full = pack.view(unit.src).float().numpy()
                    bias = pack.view(unit.bias).float().numpy()
                    good = True
                    for r in range(cl):
                        c = np.asarray(cols[r])
                        o = plan.offsets[unit.src]
                        got = cw[r, o : o + unit.K * len(c)].reshape(unit.K, len(c))
                        want = np.where(c[None] >= 0, full[:, np.maximum(c, 0)], 0.0)
                        gb = cw[r, plan.offsets[unit.bias] : plan.offsets[unit.bias] + len(c)]
                        good &= np.array_equal(got, want) and np.array_equal(
                            gb, np.where(c >= 0, bias[np.maximum(c, 0)], 0.0))
                    out[f"{q}equal/{unit.name}"] = np.array(good)
                out[q + "units"] = np.array([u.name for u in plan.units])
                out[q + "resident_units"] = np.array([u.name for u in plan.units if u.resident])
                out[q + "wbot_equal"] = np.array(all(
                    np.array_equal(cw[r, plan.offsets[k] : plan.offsets[k] + pack.view(k).numel()],
                                   pack.view(k).float().numpy().ravel())
                    for r in range(cl) for k in ("wbot", "bbot")))
                out[q + "resident_in_load"] = np.array(
                    all(plan.offsets[u.src] + u.K * len(u.cols[0]) <= plan.n_resident
                        for u in plan.units if u.resident)
                    and all(plan.offsets[u.src] >= plan.n_resident
                            for u in plan.units if not u.resident))
        # the route by B on each pack, over chunks of several lengths
        rf = net.rf
        edges = {m + e for route in sd.K2_CLUSTER_ROUTE.values() for m, _ in route for e in (0, 1)}
        for dn, dt in dtypes.items():
            pack = sd.samplernn_weight_pack(net, dt)
            for B in sorted({1, 4, 64, 256} | edges):
                taken.clear()
                prompt = torch.zeros(B, 2 * rf, dtype=torch.int32, device="meta")
                state = sd.DecodeState(*(torch.zeros(1, device="meta") for _ in range(4)))
                for n in (7, 64, 2048):
                    sd.decode_chunk(pack, prompt, state, rf, n, 0, None)
                out[f"{tag}/{dn}/route_b{B}"] = np.array(taken)
            # decode_single (K1) at every B that SampleRNN.generate sends it,
            # through the route and with each kernel forced
            single = []
            for B in range(1, 64):
                taken.clear()
                prompt = torch.zeros(B, 2 * rf, dtype=torch.int32, device="meta")
                sd.decode_single(pack, prompt, 64, 0, None)
                single.append(taken[0])
            out[f"{tag}/{dn}/single_route"] = np.array(single)
            out[f"{tag}/{dn}/cluster_size_for"] = np.array(
                [sd.cluster_size_for(pack, B) or 0 for B in range(1, 64)])
            forced = []
            for cl in (0, *sd.CLUSTER_SIZES):
                taken.clear()
                sd.decode_single(pack, torch.zeros(4, 2 * rf, dtype=torch.int32, device="meta"),
                                 64, 0, None, cl=cl)
                forced.append(taken[0])
            out[f"{tag}/{dn}/single_forced"] = np.array(forced)
        # a stream on the CPU, each chunk also sent through the route
        real_chunk = sd.decode_chunk
        from mimikit_tpu_torch.networks import sample_rnn as srn

        def routed(pack, prompt, state, t0, n, seed, temperature, **kw):
            meta = sd.DecodeState(*(torch.zeros(1, device="meta") for _ in range(4)))
            real_chunk(pack, torch.empty(prompt.shape, dtype=prompt.dtype, device="meta"), meta,
                       t0, n, seed, temperature)
            return real_chunk(pack, prompt, state, t0, n, seed, temperature, **kw)

        srn.decode_chunk = routed
        for B in (2, 64):
            taken.clear()
            prompt = torch.randint(0, spec["q_levels"], (B, 2 * rf),
                                   generator=torch.Generator().manual_seed(B))
            it = net.stream((prompt,), 8)
            for _ in range(3):
                next(it)
            it.close()
            out[f"{tag}/stream_route_b{B}"] = np.array(taken)
        srn.decode_chunk = real_chunk
    sd._launch, sd._launch_cluster = real
    return out


def mulaw_task(inp: dict) -> dict:
    """The K10 wrappers on CPU tensors (their plain twins) for every input
    and level; their launch counts; whether importing the module loaded
    triton."""
    from mimikit_tpu_torch.ops import mulaw

    out = {"triton_loaded": np.array("triton" in sys.modules)}
    for key, x in inp.items():
        if key.startswith("q/"):
            _, name, q, c = key.split("/")
            out[f"expand/{name}/{q}/{c}"] = mulaw.mulaw_expand(t(x), int(q), float(c)).numpy()
        else:
            for q, c in ((256, 1.0), (256, 0.5), (32, 1.0), (32, 0.5)):
                out[f"compress/{key[2:]}/{q}/{c}"] = mulaw.mulaw_compress(t(x), q, c).numpy()
    x = t(inp["x/randn"])
    out["cpu/launches"] = np.array([mulaw.mulaw_compress.launches, mulaw.mulaw_expand.launches])
    out["cpu/equal_plain"] = np.array(torch.equal(mulaw.mulaw_compress(x), mulaw.mulaw_compress_plain(x)))
    return out


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables inside the block."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _dtypes_of(module, name):
    """Record the weight dtype of each pack passed to ``module.name`` (its
    first argument) inside the block: yields the list."""
    fn, seen = getattr(module, name), []

    def recorded(pack, *args, **kwargs):
        seen.append(str(pack.flat.dtype))
        return fn(pack, *args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def _window_scores(net16, full, n_first, W, lead):
    """The bf16 window route's scores of positions n_first .. of ``full``
    (B, T): each position's window, the bf16 copy's forward (train mode, the
    last position's logits), batched over all windows.  (n, B, Q)."""
    from mimikit_tpu_torch import precision

    B, T = full.shape
    wins = torch.stack([full[:, p - W + lead : p + lead] for p in range(n_first, T)])
    with torch.no_grad(), precision.compute(torch.bfloat16):
        logits = net16._core((wins.reshape(-1, W),), True)[0][:, -1]
    return logits.float().reshape(T - n_first, B, -1)


def _bf16_valued(net):
    """A copy of ``net`` whose parameters hold their bf16-rounded values in
    f32: the bf16 routes' weights, products of unrounded inputs."""
    net = copy.deepcopy(net)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    return net


def bf16_decode_task(inp: dict) -> dict:
    """The bf16 decode routes on the CPU (their plain twins): SampleRNN's
    generate at B=2 (K1's route) and 64 (K2's) and stream under
    MMK_PALLAS_BF16=1, with the packs' dtypes and the bf16 twin's
    teacher-forced scores of JAX's tokens; the transformer KV stream under
    MMK_DECODE_KV=1 MMK_DECODE_BF16=1 over two chunkings, with the same; the
    bf16 window route of a SimpleTransformer (called directly, and through
    generate and a re-feed stream past _K6_MAX_BATCH streams) and of two
    JukeBoxes (called directly; a net outside K8's scope through generate),
    with the bf16 copy's scores of JAX's tokens and the copies built; the
    f32 fallback and its warning where K7's bf16 limits refuse a net."""
    from mimikit_tpu_torch.networks import sample_rnn as srnn_net
    from mimikit_tpu_torch.networks import transformers as tf_net
    from mimikit_tpu_torch.ops import transformer_kv as tk

    torch.set_num_threads(1)  # as wavenet_task
    out = {}
    n = int(inp["n_steps"])

    # SampleRNN, MMK_PALLAS_BF16=1
    net, _ = load_net(inp, "srnn/")
    rf = net.rf
    pack16 = sd.samplernn_weight_pack(net, torch.bfloat16)
    with _env(MMK_PALLAS_BF16="1"):
        for tag in ("b2", "b32", "b64"):
            with _dtypes_of(srnn_net, "decode_single") as single, \
                    _dtypes_of(srnn_net, "decode_chunk") as chunk:
                out[f"srnn/{tag}"] = net.generate((inp[f"srnn/prompt_{tag}"],), n)[0].numpy()
            out[f"srnn/{tag}_single"] = np.array(single, dtype=str)
            out[f"srnn/{tag}_chunk"] = np.array(chunk, dtype=str)
        with _dtypes_of(srnn_net, "decode_chunk") as chunk:
            out["srnn/stream"] = _stream(net, inp["srnn/prompt_b2"], 7, n // 7)
        out["srnn/stream_chunk"] = np.array(chunk, dtype=str)
    for tag in ("b2", "b32", "b64", "stream"):
        full = t(inp[f"srnn/jax_{tag}"]).to(torch.int32)
        state = sd.init_decode_state(net, full)
        L = full.shape[1]
        _, scores = sd.decode_plain(pack16, full, state, rf, L - rf, rf, L - rf, 0, None,
                                    return_scores=True)
        out[f"srnn/tf_{tag}"] = scores.numpy()  # step rf + i predicts position rf + i
    # the control: bf16 weights with f32 product inputs (no input rounding)
    net_r = _bf16_valued(net)
    for tag in ("b32", "b64"):
        prompt = t(inp[f"srnn/prompt_{tag}"]).to(torch.int32)
        out[f"ctl/srnn_{tag}"] = sd.decode_plain(net_r, prompt, sd.init_decode_state(net_r, prompt),
                                                 rf, prompt.shape[1] + n - rf, prompt.shape[1],
                                                 n, 0, None).numpy()
        full = t(inp[f"srnn/jax_{tag}"]).to(torch.int32)
        L = full.shape[1]
        _, scores = sd.decode_plain(net_r, full, sd.init_decode_state(net_r, full), rf, L - rf, rf,
                                    L - rf, 0, None, return_scores=True)
        out[f"ctl/srnn_tf_{tag}"] = scores.numpy()

    # SimpleTransformer KV stream, MMK_DECODE_KV=1 MMK_DECODE_BF16=1
    net, _ = load_transformer(inp, "kv/")
    prompt = inp["kv/prompt"]
    with _env(MMK_DECODE_KV="1", MMK_DECODE_BF16="1"):
        with _dtypes_of(tf_net, "decode_chunk") as packs:
            n_kv = 7 * int(inp["kv/n_chunks"])
            out["kv/c7"] = _stream(net, prompt, 7, n_kv // 7)
            out["kv/c9"] = _stream(net, prompt, 9, -(-n_kv // 9))
    out["kv/packs"] = np.array(packs, dtype=str)
    full = t(inp["kv/jax"]).to(torch.int32)
    pack16 = tf_net.transformer_weight_pack(net, torch.bfloat16)
    state = tk.init_kv_state(pack16, full)
    _, scores = tk.decode_chunk_plain(pack16, full.t().contiguous(), state, 1, full.shape[1] - 1,
                                      0, None, return_scores=True)
    out["kv/tf"] = scores.numpy()  # step 1 + i predicts position 1 + i
    pack_r = tf_net.transformer_weight_pack(_bf16_valued(net), torch.float32)  # the control
    prompt_T = t(prompt).to(torch.int32).t().contiguous()
    out["ctl/kv"] = tk.decode_chunk_plain(pack_r, prompt_T, tk.init_kv_state(pack_r, t(prompt).to(torch.int32)), 1,
                                          full.shape[1] - 1, 0, None)[:, prompt.shape[1] - 1:].numpy()
    _, scores = tk.decode_chunk_plain(pack_r, full.t().contiguous(), tk.init_kv_state(pack_r, full),
                                      1, full.shape[1] - 1, 0, None, return_scores=True)
    out["ctl/kv_tf"] = scores.numpy()

    # the bf16 window route, MMK_DECODE_BF16=1
    with _env(MMK_DECODE_BF16="1"):
        net, _ = load_transformer(inp, "win_tf/")
        p2, wide = t(inp["win_tf/prompt"]), inp["win_tf/prompt_wide"]
        out["win_tf/direct"] = net._window_loop(p2, n, None, 0).numpy()
        with _counting(tf_net.precision, "cast_floats") as copies:
            out["win_tf/wide"] = net.generate((wide,), n)[0].numpy()
        out["win_tf/wide_copies"] = np.array(copies[0])
        with _counting(tf_net.precision, "cast_floats") as copies:
            out["win_tf/refeed"] = _stream(net, wide, 9, 3)
        out["win_tf/refeed_copies"] = np.array(copies[0])
        net16, W = net._window_net(), net._window_len()
        out["win_tf/copy_dtype"] = np.array(str(next(net16.parameters()).dtype))
        for tag in ("direct", "wide"):
            full = t(inp[f"win_tf/jax_{tag}"]).long()
            out[f"win_tf/tf_{tag}"] = _window_scores(net16, full, full.shape[1] - n, W, 0).numpy()
        for tag in ("jb", "jb_out"):
            net, _ = load_jukebox(inp, f"win_{tag}/")
            prompt = t(inp[f"win_{tag}/prompt"])
            if tag == "jb":
                out[f"win_{tag}/tokens"] = net._window_loop(prompt, n, None, 0).numpy()
            else:
                with _counting(tf_net.precision, "cast_floats") as copies:
                    out[f"win_{tag}/tokens"] = net.generate((prompt,), n)[0].numpy()
                out[f"win_{tag}/copies"] = np.array(copies[0])
            full = t(inp[f"win_{tag}/jax"]).long()
            out[f"win_{tag}/tf"] = _window_scores(net._window_net(), full, full.shape[1] - n,
                                                  net._window_len(), 1).numpy()

    # K7's bf16 limits refuse the net (d / n_heads = 20): the f32 K7 route, warned
    cfg = mmk.Config.deserialize(str(inp["warn/yaml"]))
    cfg.io_spec.bind_to({"signal": mmk.Extractor.signal()})
    net = mmk.SimpleTransformer.from_config(cfg, device="cpu", seed=3).eval()
    prompt = inp["warn/prompt"]
    with _env(MMK_DECODE_KV="1"):
        out["warn/f32"] = _stream(net, prompt, 7, 10)
        with _env(MMK_DECODE_BF16="1"), _dtypes_of(tf_net, "decode_chunk") as packs, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["warn/bf16"] = _stream(net, prompt, 7, 10)
    out["warn/packs"] = np.array(packs, dtype=str)
    out["warn/warnings"] = np.array([str(w.message) for w in caught], dtype=str)
    return out


def _unrounded(fn):
    """``fn`` (an LSTM plain version) in f32 on the bf16 streams' values,
    its outputs rounded to bf16: a kernel that skips the rounding of h and
    dz (the control of ``test_torch_bf16_train.py``)."""
    def run(*streams):
        return tuple(o.to(torch.bfloat16) for o in fn(*(v.float() for v in streams)))
    return run


GRAD_NAMES = ("dx", "dWi", "dWh", "db", "dh0", "dc0")


def _bf16_layer(fl, inp, p, out, q):
    """The bf16 layer's outputs and six gradients (all cotangents; h_all's
    only) on the case ``p``, saved under ``q``."""
    args = [t(inp[p + n]).to(torch.bfloat16).requires_grad_()
            for n in ("x", "Wi", "Wh", "b", "h0", "c0")]
    cts = [t(inp[p + n]).to(torch.bfloat16) for n in ("dh_all", "dh_T", "dc_T")]
    res = fl.fused_lstm_layer(*args)
    for n, v in zip(("h_all", "h_T", "c_T"), res):
        out[q + n] = v.detach().float().numpy()
    for n, g in zip(GRAD_NAMES, torch.autograd.grad(res, args, cts)):
        out[q + "grad_" + n] = g.float().numpy()
    res = fl.fused_lstm_layer(*args)
    for n, g in zip(GRAD_NAMES, torch.autograd.grad(res[0], args, cts[0])):
        out[q + "grad_h_only_" + n] = g.float().numpy()


def bf16_train_task(inp: dict) -> dict:
    """The bf16 training path on the CPU: the bf16 fused LSTM layer (and its
    control) on JAX's cases; the dtypes of SampleRNN's train forward under
    the policy; three TrainARMLoop steps under ``param_dtype="bfloat16"``
    from the JAX weights; the cross-entropy of bf16 logits."""
    from mimikit_tpu_torch import precision
    from mimikit_tpu_torch.ops import fused_lstm as fl

    out = {}
    for tag in sorted({k.split("/")[1] for k in inp if k.startswith("layer/")}):
        p = f"layer/{tag}/"
        _bf16_layer(fl, inp, p, out, p)
        saved = fl.lstm_forward, fl.lstm_backward
        fl.lstm_forward = _unrounded(fl.lstm_forward_plain)
        fl.lstm_backward = _unrounded(fl.lstm_backward_plain)
        try:
            _bf16_layer(fl, inp, p, out, f"control/{tag}/")
        finally:
            fl.lstm_forward, fl.lstm_backward = saved

    work = str(inp["work"])
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))
    db = ds.get(mode="r")
    cfg = mmk.Config.deserialize(str(inp["train_yaml"]))
    cfg.root_dir = f"{work}/port_bf16"
    net_cfg = mmk.Config.deserialize(str(inp["net_yaml"]))
    net_cfg.io_spec.bind_to(ds)
    net = mmk.SampleRNN.from_config(net_cfg, device="cpu")
    net.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))

    # the train forward under the policy: every float output and carry
    inputs, _ = next(iter(mmk.TrainARMLoop.get_dataloader(db, net, cfg)))
    with precision.compute(torch.bfloat16):
        outputs, hidden = torch.func.functional_call(
            net, precision.cast_parameters(net, torch.bfloat16),
            (tuple(torch.as_tensor(x) for x in inputs), None))
    leaves = list(outputs) + [x for tier in hidden for layer in tier for x in layer]
    out["forward_dtypes"] = np.array([str(x.dtype) for x in leaves])

    loop = mmk.TrainARMLoop.from_config(cfg, db, net)
    loop.run()
    out["losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
    out["master_dtypes"] = np.array(sorted({str(p.dtype) for p in net.parameters()} | {
        str(v.dtype) for st in loop.opt.adam.state.values() for v in st.values()
        if isinstance(v, torch.Tensor) and v.is_floating_point()}))

    logits = t(inp["ce_logits"]).to(torch.bfloat16)
    out["ce_huge"] = mmk.cross_entropy(logits, t(inp["ce_targets"])).numpy()
    return out


def xla_dot_task(inp: dict) -> dict:
    """``rounding.matmul`` (f32, before the bf16 rounding) of each case's
    operands, the left one read transposed where the case says so."""
    from mimikit_tpu_torch.modules import rounding

    out = {}
    for key in sorted({k.rsplit("/", 1)[0] for k in inp if k.endswith("/a")}):
        a, b = torch.from_numpy(inp[key + "/a"]), torch.from_numpy(inp[key + "/b"])
        out[key] = rounding.matmul(a, b, lhs_transposed=bool(inp[key + "/lhs_t"])).numpy()
    return out


def wavenet_cluster_task(inp: dict) -> dict:
    """The WaveNet cluster kernel's plan and relayout at each net's widths,
    cluster size and group size, and the wrappers' route by B (the launchers
    replaced by recorders, the tensors on the meta device so that the route
    is taken without a card), over chunks of several lengths."""
    from mimikit_tpu_torch.ops import wavenet_decode as wd

    torch.set_num_threads(1)
    out = {"route": np.array(wd.WN_CLUSTER_ROUTE), "sizes": np.array(wd.CLUSTER_SIZES),
           "smem_per_block": np.array(sd.SMEM_PER_BLOCK)}
    taken = []

    def block(pack, prompt, state, t0, n, o, out_t0, seed, temp, group=None):
        taken.append("block")
        return True

    def cluster(pack, prompt, state, t0, n, o, out_t0, seed, temp, cl, S=None, record=None):
        taken.append(f"cluster{cl}")
        return True

    real = wd._launch, wd._launch_cluster
    wd._launch, wd._launch_cluster = block, cluster
    try:
        for tag in sorted({k.split("/")[0] for k in inp if k.startswith("net_")}):
            spec = json.loads(str(inp[f"{tag}/spec"]))
            io = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
                q_levels=spec["q_levels"], mlp_dim=spec["mlp_dim"], input_module_type="embedding"))
            net = mmk.WaveNet.from_config(mmk.WaveNet.Config(
                io_spec=io, blocks=tuple(spec["blocks"]), dims_dilated=(spec["dim"],),
                skips_dim=spec["dim"], residuals_dim=spec["dim"], pad_side=0),
                device="cpu", seed=3).eval()
            pack = wd.wavenet_weight_pack(net)
            out[f"{tag}/gate"] = np.array(wd.supports_kernel_decode(net))
            out[f"{tag}/exchanges"] = np.array(wd.exchanges_per_step(pack))
            out[f"{tag}/has_res"] = np.array(pack.has_res)
            for cl in wd.CLUSTER_SIZES:
                q = f"{tag}/cl{cl}/"
                S_max = wd.max_streams(pack, cl)
                out[q + "max_streams"] = np.array(S_max)
                out[q + "why"] = np.array(wd.cluster_plan(pack, cl, 1).why)
                if not S_max:
                    continue
                groups = sorted({1, S_max, *[min(S_max, -(-256 // c)) for c in (7, 8, 15, 16)]})
                out[q + "groups"] = np.array(groups)
                plans = [wd.cluster_plan(pack, cl, S) for S in groups]
                out[q + "smem"] = np.array([p.smem_bytes for p in plans])
                # the buffers the kernel carves, the resident region and the ring
                out[q + "smem_sum"] = np.array([4 * (p.act_floats + p.wreg_floats) + (
                    4 * wd.RING_SLOTS * wd.SLOT_FLOATS if any(p.pieces(r) for r in range(cl))
                    else 0) for p in plans])
                cw, tabs, plan = wd.cluster_layout(pack, cl, S_max)
                cw, tabs = cw.numpy(), tabs.numpy()
                out[q + "units"] = np.array([u.name for u in plan.units])
                equal, aligned = [], []
                for u, unit in enumerate(plan.units):
                    width = max(len(c) for c in unit.cols)  # ragged ranks padded with -2
                    out[f"{q}cols/{unit.name}"] = np.array(
                        [list(c) + [-2] * (width - len(c)) for c in unit.cols])
                    out[f"{q}N/{unit.name}"] = np.array(unit.N)
                    W = pack.view(unit.src).numpy()
                    b = pack.view(unit.bias).numpy()
                    ok = True
                    for r in range(cl):
                        t = tabs[r]
                        base, n_units = int(t[0]), int(t[3])
                        off, boff, nq = (int(x) for x in t[4 + 3 * u : 7 + 3 * u])
                        cols = np.asarray(unit.cols[r], np.int64)
                        assert nq * 4 == len(cols) and n_units == len(plan.units)
                        want_b = np.where(cols < 0, 0.0, b[np.maximum(cols, 0)])
                        want = np.where(cols[None, :] < 0, 0.0, W[:, np.maximum(cols, 0)])
                        ok &= np.array_equal(cw[base + boff : base + boff + len(cols)], want_b)
                        aligned += [base, boff]
                        # quad-major: a quad's K rows of four columns together, in
                        # blocks of 128 of each segment (k < ka, k >= ka) the row
                        # of k = 4 l + e at e nb / 4 + l
                        order = []
                        for lo, hi in ((0, unit.ka), (unit.ka, unit.K)):
                            for k0 in range(lo, hi, 128):
                                nb = min(128, hi - k0)
                                order += [k0 + 4 * ll + ee for ee in range(4)
                                          for ll in range(nb // 4)]
                        want = want.reshape(unit.K, -1, 4)[order].transpose(1, 0, 2)
                        if off >= 0:
                            got = cw[base + off : base + off + want.size].reshape(want.shape)
                            ok &= np.array_equal(got, want)
                            aligned.append(off)
                        else:  # its pieces, in the table's order, quads at a time
                            pieces = [p for p in plan.pieces(r) if p[0] == u]
                            n_pieces = int(t[2])
                            first = [i for i, p in enumerate(plan.pieces(r)) if p[0] == u][0]
                            assert n_pieces == len(plan.pieces(r))
                            for i, (_, q0, nqp) in enumerate(pieces):
                                poff, pfl = (int(x) for x in t[4 + 3 * n_units + 2 * (first + i):
                                                                 6 + 3 * n_units + 2 * (first + i)])
                                got = cw[base + poff : base + poff + pfl]
                                ok &= np.array_equal(got, want[q0 : q0 + nqp].ravel())
                                aligned += [poff, pfl]
                    equal.append(bool(ok))
                out[q + "equal"] = np.array(equal)
                out[q + "aligned"] = np.array(aligned) * 4
                one = wd.cluster_plan(pack, cl, 1)
                out[q + "resident_bytes"] = np.array([one.bytes(r, True) for r in range(cl)])
                out[q + "streamed_bytes"] = np.array([one.bytes(r, False) for r in range(cl)])
                out[q + "load_floats"] = tabs[:, 1]
                out[q + "wreg_floats"] = np.array(plan.wreg_floats)
            # the route by B, through both wrappers, over chunks of several lengths
            mpack = dtc.replace(pack, flat=pack.flat.to("meta"))
            for B in (1, 8, 32, 64, 65, 128, 129, 256):
                prompt = torch.zeros(B, 40, dtype=torch.int32, device="meta")
                taken.clear()
                wd.decode_single(mpack, prompt, 16, 0, None)
                state = wd.init_decode_state(mpack, prompt)
                for t0, n in ((1, 100), (101, 7), (108, 1600)):
                    wd.decode_chunk(mpack, prompt, state, t0, n, 0, 0.9)
                out[f"{tag}/route_b{B}"] = np.array(taken)
                out[f"{tag}/route_fn_b{B}"] = np.array(wd.route(pack, B) or 0)
    finally:
        wd._launch, wd._launch_cluster = real
    return out


def _lstm_module(inp: dict, p: str, H: int, n_layers: int):
    """The port's LSTM with the weights under ``p`` (``w_ih{k}`` (4H, D),
    ``w_hh{k}``, ``b_hh{k}``), and a counter of its fused-layer calls."""
    from mimikit_tpu_torch.modules import rnn

    m = rnn.LSTM(H, n_layers)
    with torch.no_grad():
        for k in range(n_layers):
            getattr(m, f"weight_ih_l{k}").copy_(t(inp[f"{p}w_ih{k}"]))
            getattr(m, f"weight_hh_l{k}").copy_(t(inp[f"{p}w_hh{k}"]))
            getattr(m, f"bias_hh_l{k}").copy_(t(inp[f"{p}b_hh{k}"]))
    return m


def lstm_route_task(inp: dict) -> dict:
    """``lstm_route`` at each case of ``inp["route_cases"]`` (B, T, H,
    element bytes), or its error; the wide plan and the wide kernels' shared
    memory at each H of ``inp["wide_h"]``; and the LSTM module at the "scan"
    and the "wide" cases: outputs, final carries and the gradients of
    sum(y * gy) + sum over layers of sum(c * gc + h * gh) with respect to x,
    every parameter and the initial carry, with the route each layer took and
    the module's calls of the fused layer; at the "past" case (H past the
    wide kernels' limit inside JAX's gate) also the module's own step loop's
    outputs and the error the card's route raises."""
    from mimikit_tpu_torch.modules import rnn
    from mimikit_tpu_torch.ops import fused_lstm as fl

    out = {}
    for B, T, H, es in inp["route_cases"].tolist():
        key = f"route/b{B}_t{T}_h{H}_e{es}"
        try:
            dtype = torch.float32 if es == 4 else torch.bfloat16
            out[key] = np.array(fl.lstm_route(B, T, H, dtype))
        except ValueError as e:
            out[key + "_error"] = np.array(str(e))
    for H in inp["wide_h"].tolist():
        for es in (4, 2):
            try:
                out[f"wide/h{H}_e{es}/plan"] = np.array(fl.lstm_wide_plan(32, H, es))
            except ValueError as e:
                out[f"wide/h{H}_e{es}/error"] = np.array(str(e))
            for bw in (0, 1):
                out[f"wide/h{H}_e{es}_bw{bw}/smem"] = np.array(fl._wide_smem(H, es, bool(bw)))
    out["smem_limit"] = np.array(fl.SMEM_PER_BLOCK)

    real, calls = rnn.fused_lstm_layer, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    rnn.fused_lstm_layer = counted
    try:
        for case in ("scan", "wide", "past"):
            p = f"{case}/"
            L = int(inp[p + "layers"])
            x = t(inp[p + "x"]).clone().requires_grad_()
            B, T, H = x.shape
            m = _lstm_module(inp, p, H, L)
            carry = tuple((t(inp[f"{p}c0_{k}"]).clone().requires_grad_(),
                           t(inp[f"{p}h0_{k}"]).clone().requires_grad_()) for k in range(L))
            calls.clear()
            y, final = m.forward_seq(x, carry)
            out[p + "fused_calls"] = np.array(len(calls))
            out[p + "route"] = np.array(fl.lstm_route(B, T, H, x.dtype, cpu=True))
            if case == "past":
                try:
                    fl.lstm_route(B, T, H, x.dtype)
                except ValueError as e:
                    out[p + "card_error"] = np.array(str(e))
                with torch.no_grad():
                    ys, h, c = m._scan(0, x.transpose(0, 1), carry[0][1], carry[0][0])
                out[p + "scan_y"], out[p + "scan_h_0"] = ys.transpose(0, 1).numpy(), h.numpy()
                out[p + "scan_c_0"] = c.numpy()
            loss = (y * t(inp[p + "gy"])).sum()
            for k, (c, h) in enumerate(final):
                loss = loss + (c * t(inp[f"{p}gc_{k}"])).sum() + (h * t(inp[f"{p}gh_{k}"])).sum()
                out[f"{p}c_{k}"], out[f"{p}h_{k}"] = c.detach().numpy(), h.detach().numpy()
            loss.backward()
            out[p + "y"] = y.detach().numpy()
            out[p + "grad_x"] = x.grad.numpy()
            for k in range(L):
                for n in ("weight_ih", "weight_hh", "bias_hh"):
                    out[f"{p}grad_{n}{k}"] = getattr(m, f"{n}_l{k}").grad.numpy()
                out[f"{p}grad_c0_{k}"] = carry[k][0].grad.numpy()
                out[f"{p}grad_h0_{k}"] = carry[k][1].grad.numpy()
            out[p + "launches"] = np.array(fl.lstm_forward.launches + fl.lstm_backward.launches
                                           + fl.lstm_forward_wide.launches
                                           + fl.lstm_backward_wide.launches)
    finally:
        rnn.fused_lstm_layer = real
    return out


def _wide_dh(fl, dz, Wh):
    """dz @ Wh^T (B x 4H times 4H x H) summed in the order of K3b-wide's
    walk: block q's partial over its units' four gate columns, the blocks
    of a cluster in rank order, then the clusters in ``G`` groups of
    ``CPG``, each group in cluster order from 0, the groups in order."""
    B, H = dz.shape[0], Wh.shape[0]
    s = fl._wide_shape(H, 4, True)
    U, CL = s["U"], fl.WIDE_CL
    parts = []
    for q in range(fl.WIDE_BLOCKS):
        cols = [g * H + q * U + u for g in range(4) for u in range(U)]
        parts.append(dz[:, cols] @ Wh[:, cols].t())
    clusters = []
    for c in range(s["NCL"]):
        v = parts[c * CL]
        for r in range(1, CL):
            v = v + parts[c * CL + r]
        clusters.append(v)
    dh = torch.zeros(B, H)
    for gi in range(s["G"]):
        v = torch.zeros(B, H)
        for c in range(gi * s["CPG"], min(s["NCL"], (gi + 1) * s["CPG"])):
            v = v + clusters[c]
        dh = dh + v
    return dh


def _wide_walk(fl, dh_all, dh_T, dc_T, gates, c_all, c0, Wh):
    """``lstm_backward_plain``'s walk (f32) with each step's dz @ Wh^T summed
    by ``_wide_dh``: (dxi, dh0, dc0)."""
    T, B, H = c_all.shape
    dh_c, dc_c = dh_T, dc_T
    dxi = torch.empty(gates.shape)
    for t in range(T - 1, -1, -1):
        dh = dh_all[t] + dh_c
        i, f, g, o = gates[t].split(H, dim=1)
        tc = torch.tanh(c_all[t])
        dc = dc_c + dh * o * (1.0 - tc * tc)
        c_prev = c_all[t - 1] if t > 0 else c0
        dz = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=1)
        dxi[t] = dz
        dh_c = _wide_dh(fl, dz, Wh)
        dc_c = dc * f
    return dxi, dh_c, dc_c


def lstm_wide_layout_task(inp: dict) -> dict:
    """The wide kernels' layout (``_wide_shape``, ``_wide_smem``) at each H
    of ``inp["wide_h"]``, both stream types and both directions, with the
    constants it rests on; and at each case of ``inp["walk_cases"]`` (T, B,
    H) the backward walk with dh summed in K3b-wide's order (``_wide_walk``)
    beside ``lstm_backward_plain`` on the same inputs."""
    from mimikit_tpu_torch.ops import fused_lstm as fl

    out = {"blocks": np.array(fl.WIDE_BLOCKS), "cl": np.array(fl.WIDE_CL),
           "rp": np.array(fl.WIDE_RP), "smem_limit": np.array(fl.SMEM_PER_BLOCK),
           "threads": np.array(fl.THREADS)}
    for H in inp["wide_h"].tolist():
        for es in (4, 2):
            for bw in (0, 1):
                k = f"h{H}_e{es}_bw{bw}/"
                for name, v in fl._wide_shape(H, es, bool(bw)).items():
                    out[k + name] = np.array(v)
                out[k + "smem"] = np.array(fl._wide_smem(H, es, bool(bw)))
    for T, B, H in inp["walk_cases"].tolist():
        p = f"walk/t{T}_b{B}_h{H}/"
        xi, Wh, h0, c0, dh_all, dh_T, dc_T = (torch.from_numpy(inp[p + n]) for n in (
            "xi", "Wh", "h0", "c0", "dh_all", "dh_T", "dc_T"))
        h_all, c_all, gates = fl.lstm_forward_plain(xi, Wh, h0, c0)
        dxi, _, dh0, dc0 = fl.lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0,
                                                  c0, Wh)
        wdxi, wdh0, wdc0 = _wide_walk(fl, dh_all, dh_T, dc_T, gates, c_all, c0, Wh)
        for n, v in (("dxi", dxi), ("dh0", dh0), ("dc0", dc0), ("wide_dxi", wdxi),
                     ("wide_dh0", wdh0), ("wide_dc0", wdc0)):
            out[p + n] = v.numpy()
        dz = dxi[-1]
        out[p + "dz_wh"] = (dz @ Wh.t()).numpy()
        out[p + "wide_dz_wh"] = _wide_dh(fl, dz, Wh).numpy()
    # the residency check, with the card's answer replaced: one cluster short, then enough
    real = fl.wide_clusters_that_fit
    for name, short in (("resident_short", 1), ("resident_enough", 0)):
        fl.wide_clusters_that_fit = lambda H, bw, dt, k=short: fl.WIDE_BLOCKS // fl.WIDE_CL - k
        try:
            fl._wide_resident(512, True, torch.float32)
            out[name] = np.array("")
        except RuntimeError as e:
            out[name] = np.array(str(e))
        finally:
            fl.wide_clusters_that_fit = real
    return out


# -- per-row temperatures ----------------------------------------------------------------

def _jittered(net, seed, scale):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p_ in net.parameters():
            p_.add_(torch.randn(p_.shape, generator=g) * scale)
    return net.eval()


def _temperature_nets():
    """The small nets of each family (weights from a seed, jittered so the
    decodes vary), on the CPU."""
    def io(emb, **kw):
        return mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(
            q_levels=32, mlp_dim=16, input_module_type="embedding" if emb else "framed_linear",
            **kw))

    return {
        "samplernn": _jittered(mmk.SampleRNN.from_config(mmk.SampleRNN.Config(
            frame_sizes=(8, 4, 2), hidden_dim=16, io_spec=io(False)), device="cpu", seed=1), 2,
            0.5),
        "wavenet": _jittered(mmk.WaveNet.from_config(mmk.WaveNet.Config(
            io_spec=io(True), blocks=(3,), dims_dilated=(16,), skips_dim=16, residuals_dim=16,
            pad_side=0), device="cpu", seed=1), 2, 0.3),
        "transformer": _jittered(mmk.SimpleTransformer.from_config(mmk.SimpleTransformer.Config(
            io_spec=io(True), model_dim=32, n_heads=4, feedforward_dim=64, num_layers=2, rf=16,
            input_dropout=0.0), device="cpu", seed=1), 2, 0.1),
        "jukebox": _jittered(mmk.JukeBox.from_config(mmk.JukeBox.Config(
            io_spec=io(False), frame_sizes=(8, 4, 2), model_dim=32, n_heads=4,
            feedforward_dim=64, num_layers=2, rf=16, input_dropout=0.0), device="cpu", seed=1),
            2, 0.1),
    }


class _Recorder:
    """``torch`` with ``argmax`` recording its input (a decode's scores)."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def argmax(self, x, *a, **k):
        self.seen.append(x.clone())
        return torch.argmax(x, *a, **k)


def temperature_task(inp: dict) -> dict:
    """Each decode path of each family at one temperature, a 1-tuple, one
    temperature a row (``inp["temps"]``) and each row's own scalar, all with
    one seed; a wrong length; and the plain twins' scores with the noise set
    to zero, at argmax and at the per-row temperatures."""
    from unittest import mock

    from mimikit_tpu_torch.ops import jukebox_decode as jbd
    from mimikit_tpu_torch.ops import noise
    from mimikit_tpu_torch.ops import transformer_decode as td
    from mimikit_tpu_torch.ops import transformer_kv as tk
    from mimikit_tpu_torch.ops import wavenet_decode as wd

    torch.set_num_threads(1)
    temps = tuple(float(x) for x in inp["temps"])
    B, n, seed = len(temps), int(inp["n_steps"]), 5
    nets = _temperature_nets()
    g = torch.Generator().manual_seed(3)
    prompts = {k: torch.randint(0, 32, (B, L), generator=g, dtype=torch.int32)
               for k, L in (("samplernn", 16), ("wavenet", 16), ("wavenet_short", 4),
                            ("transformer", 32), ("jukebox", 32))}
    chunked = copy.deepcopy(nets["samplernn"])
    chunked._CHUNKED_MIN_B, chunked._CHUNK = 1, 16
    k6_less = copy.deepcopy(nets["transformer"])
    k6_less._K6_MAX_BATCH = 0

    def stream(net, prompt, chunk, **kw):
        return _stream(net, prompt, chunk, n // chunk, **kw)

    def kv_stream(prompt, **kw):
        with _env(MMK_DECODE_KV="1"):
            return stream(nets["transformer"], prompt, 8, **kw)

    def jukebox_window(prompt, **kw):
        with mock.patch.object(jbd, "supports_kernel_decode", lambda net: False):
            return nets["jukebox"].generate((prompt,), n, **kw)[0].numpy()

    paths = {
        "samplernn": lambda p, **kw: nets["samplernn"].generate((p,), n, **kw)[0].numpy(),
        "samplernn_chunked": lambda p, **kw: chunked.generate((p,), n, **kw)[0].numpy(),
        "samplernn_stream": lambda p, **kw: stream(nets["samplernn"], p, 8, **kw),
        "wavenet": lambda p, **kw: nets["wavenet"].generate((p,), n, **kw)[0].numpy(),
        "wavenet_stream": lambda p, **kw: stream(nets["wavenet"], p, 8, **kw),
        "wavenet_step_loop": lambda p, **kw: nets["wavenet"].generate((p,), n, **kw)[0].numpy(),
        "transformer": lambda p, **kw: nets["transformer"].generate((p,), n, **kw)[0].numpy(),
        "transformer_window": lambda p, **kw: k6_less.generate((p,), n, **kw)[0].numpy(),
        "transformer_kv": kv_stream,
        "jukebox": lambda p, **kw: nets["jukebox"].generate((p,), n, **kw)[0].numpy(),
        "jukebox_stream": lambda p, **kw: stream(nets["jukebox"], p, 8, **kw),
        "jukebox_window": jukebox_window,
    }
    prompt_of = {"wavenet_step_loop": "wavenet_short"}
    out = {}
    for name, run in paths.items():
        p = prompts[prompt_of.get(name, name.split("_")[0])]
        out[f"{name}/scalar"] = run(p, temperature=temps[0], seed=seed)
        out[f"{name}/one"] = run(p, temperature=(temps[0],), seed=seed)
        out[f"{name}/rows"] = run(p, temperature=temps, seed=seed)
        out[f"{name}/each"] = np.stack([run(p, temperature=v, seed=seed)[b]
                                        for b, v in enumerate(temps)])
        try:
            run(p, temperature=temps + temps[:1], seed=seed)
            out[f"{name}/wrong"] = np.array("ran")
        except Exception as e:  # noqa: BLE001 - the type is the result
            out[f"{name}/wrong"] = np.array(type(e).__name__)

    # the plain twins' scores, the noise set to zero: argmax, then per-row
    zero = lambda seed_, t_, B_, Q, dev: torch.zeros(B_, Q, device=dev)  # noqa: E731
    srnn, wn, tf, jb = (nets[k] for k in ("samplernn", "wavenet", "transformer", "jukebox"))
    wpack, tpack, jpack = (wd.wavenet_weight_pack(wn), td.transformer_weight_pack(tf),
                           jbd.jukebox_weight_pack(jb))

    def twin_scores(t):
        res = {}
        p = prompts["samplernn"]
        res["samplernn"] = sd.decode_plain(srnn, p, sd.init_decode_state(srnn, p), srnn.rf, n,
                                           srnn.rf, n, seed, t, return_scores=True)[1]
        p = prompts["wavenet"]
        res["wavenet"] = wd.decode_plain(wpack, p, wd.init_decode_state(wpack, p), 1, n, 1, n,
                                         seed, t, return_scores=True)[1]
        p = prompts["transformer"]
        res["transformer"] = td.decode_window_plain(tpack, p, p.shape[1], n, seed, t,
                                                    return_scores=True)[1]
        res["transformer_kv"] = tk.decode_chunk_plain(
            tpack, p.t().contiguous(), tk.init_kv_state(tpack, p), 1, n, seed, t,
            return_scores=True)[1]
        rec = _Recorder()
        p = prompts["jukebox"]
        with mock.patch.object(jbd, "torch", rec):
            jbd.decode_pyramid_plain(jpack, jbd.lead_window(p, jpack.window), p.shape[1], n,
                                     seed, t)
        res["jukebox"] = torch.stack(rec.seen)
        return res

    mods = (sd, wd, td, tk, jbd)
    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(mock.patch.object(m, "gumbel_noise", zero))
        logits, tempered = twin_scores(None), twin_scores(temps)
    for k in logits:
        # (B, steps, Q), as a step's logits reach the sampler
        out[f"scores/{k}/logits"] = logits[k].transpose(0, 1).numpy()
        out[f"scores/{k}/tempered"] = tempered[k].transpose(0, 1).numpy()
    out["noise_is_the_decodes"] = np.array(all(m.gumbel_noise is noise.gumbel_noise
                                               for m in mods))
    return out


# -- GenerateLoopV2 ------------------------------------------------------------------------

_FROM_JAX = {"samplernn": (mmk.SampleRNN, mmk.samplernn_state_dict_from_jax),
             "wavenet": (mmk.WaveNet, mmk.wavenet_state_dict_from_jax),
             "transformer": (mmk.SimpleTransformer, mmk.transformer_state_dict_from_jax),
             "jukebox": (mmk.JukeBox, mmk.jukebox_state_dict_from_jax)}


def _net_from_jax(inp: dict, kind: str, ds):
    """The port's ``kind`` net from the JAX-written YAML (bound to ``ds``),
    with the JAX weights, on the CPU."""
    cls, to_sd = _FROM_JAX[kind]
    cfg = mmk.Config.deserialize(str(inp[f"{kind}/yaml"]))
    cfg.io_spec.bind_to(ds)
    net = cls.from_config(cfg, device="cpu")
    net.load_state_dict(to_sd(unflatten(inp, f"{kind}/params/")), strict=True)
    return net


def _gen_config(inp: dict, pre: str = "", **kw):
    """The loop's config from ``inp``'s ``<pre>output_sec``, ``<pre>prompt_sec``
    and ``<pre>positions``."""
    return mmk.GenerateLoopV2.Config(
        output_duration_sec=float(inp[pre + "output_sec"]),
        prompts_length_sec=float(kw.pop("prompt_sec", inp[pre + "prompt_sec"])),
        prompts_position_sec=tuple(float(x) for x in inp[pre + "positions"]),
        parameters=dict(temperature=None), batch_size=int(inp["batch_size"]),
        display_waveform=False, **kw)


def _loop_outputs(loop):
    return np.concatenate([np.asarray(o[0]) for o in loop.run()], 0)


class _UntilARM(mmk.ARM):
    """A two-input, two-target ARM whose step writes one step of the first
    buffer and three of the second (the loop then visits every third step),
    as ``tests/test_generate_loop``'s JAX counterpart of ``TestARM``."""

    @classmethod
    def from_config(cls, config):
        return cls()

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(1, 1)

    config = property(lambda self: None)
    rf = property(lambda self: 8)
    generate_params = property(lambda self: set())

    def train_batch(self, item_spec):
        raise NotImplementedError

    def test_batch(self, item_spec):
        raise NotImplementedError

    def before_generate(self, prompts, batch_index):
        self.calls = 0

    def generate_step(self, inputs, *, t=0, **parameters):
        self.calls += 1
        x0, x1 = inputs
        return x0[:, -1:] * 0.5 + t, (torch.cat([x1[:, -1:] + k for k in range(3)], 1) % 256)

    def after_generate(self, final_outputs, batch_index):
        self.done = True


def generate_loop_task(inp: dict) -> dict:
    """GenerateLoopV2 over the JAX-written dataset for each net (argmax
    tokens and mu-law expanded outputs), SampleRNN's stepwise loop (a prompt
    of a multiple of rf samples and one with an offset), the warning of a
    ``generate`` that takes no temperature, and the until-writing ARM."""
    torch.set_num_threads(1)
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(int(inp["sr"])),))
    db = ds.get(mode="r")
    out = {}
    for kind in _FROM_JAX:
        net = _net_from_jax(inp, kind, ds)
        loop = mmk.GenerateLoopV2.from_config(_gen_config(inp, yield_inversed_outputs=False),
                                              db, net)
        out[f"{kind}/n_steps"] = np.array(loop.n_steps)
        out[f"{kind}/tokens"] = _loop_outputs(loop)
        out[f"{kind}/training_restored"] = np.array(net.training)
        loop = mmk.GenerateLoopV2.from_config(_gen_config(inp), db, net)
        out[f"{kind}/audio"] = _loop_outputs(loop)
    srnn = _net_from_jax(inp, "samplernn", ds).eval()
    for tag, prompt_sec in (("aligned", inp["step_prompt_sec"]),
                            ("offset", inp["offset_prompt_sec"])):
        cfg = _gen_config(inp, "step_", prompt_sec=prompt_sec, yield_inversed_outputs=False)
        loop = mmk.GenerateLoopV2.from_config(cfg, db, srnn)
        batch = next(iter(loop.dataloader))
        idx, batch = np.asarray(batch[0]).reshape(-1), batch[1:]
        out[f"stepwise/{tag}"] = loop._stepwise(batch, idx, {"temperature": None})[0]
        out[f"stepwise/{tag}/generate"] = srnn.generate(batch, loop.n_steps)[0].numpy()
    # a generate that does not take the temperature: the stepwise loop, and a warning
    cfg = _gen_config(inp, "step_", yield_inversed_outputs=False)
    out["warned/generate"] = _loop_outputs(mmk.GenerateLoopV2.from_config(cfg, db, srnn))
    gen = srnn.generate
    srnn.generate = lambda prompts, n_steps: gen(prompts, n_steps)
    loop = mmk.GenerateLoopV2.from_config(cfg, db, srnn)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["warned/tokens"] = _loop_outputs(loop)
        _loop_outputs(loop)  # once a loop
    out["warned/messages"] = np.array([str(w.message) for w in caught])
    # the until-writing ARM
    arm = _UntilARM()
    loop = mmk.GenerateLoopV2(mmk.GenerateLoopV2.Config(), arm, int(inp["until_steps"]), None)
    res = loop._stepwise((inp["until_x0"], inp["until_x1"]), np.arange(2), {})
    out["until/x0"], out["until/x1"] = res
    out["until/calls"], out["until/done"] = np.array(arm.calls), np.array(arm.done)
    db.close()
    return out


# -- the loggers, audio in and out ---------------------------------------------------------

def loggers_task(inp: dict) -> dict:
    """``EpochMetrics``, ``LossLogger`` (h5py, then the npz container),
    ``AudioLogger`` (a template, a WAV, the fallback of another extension, a
    multichannel refusal), ``write_wav``, ``load_audio`` and ``FileToSignal``
    across rates, and ``GradNormCallback.grad_norm``."""
    from mimikit_tpu_torch.data import h5
    from mimikit_tpu_torch.features import audio_io
    from mimikit_tpu_torch.loops import callbacks, logger

    work, out = str(inp["work"]), {}
    m = logger.EpochMetrics(print_fn=lambda *_: None)
    m.on_epoch_start()
    m.log_output({"loss": 2.0, "acc": 0.5})
    m.log_output({"loss": 4.0, "acc": 1.0})
    avg = m.averages()
    out["metrics/avg"] = np.array([avg["loss"], avg["acc"]])
    try:
        m.check_loss(float("nan"))
        out["metrics/nan"] = np.array("ran")
    except RuntimeError as e:
        out["metrics/nan"] = np.array(f"RuntimeError: {e}")
    for backend in ("h5py", "npz"):
        h5py_module = h5.h5py
        if backend == "npz":
            h5.h5py = None
        try:
            path = f"{work}/{backend}/logs/metrics.h5"
            ll = logger.LossLogger(path)
            ll.log_metrics({"loss": 1.5, "lr": 1e-3}, step=0)
            ll.log_metrics({"loss": 1.25}, step=1)
            ll.log_metrics({"loss": 1.0}, step=1)  # the same step again
            m.flush_epoch(2, logger=ll)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with h5.File(path, "r") as f:
                    out[f"{backend}/read"] = np.array(
                        [float(f[k][0]) for k in ("0/loss", "0/lr", "1/loss", "2/loss", "2/acc")])
                    out[f"{backend}/groups"] = np.array(sorted(f.keys()))
            out[f"{backend}/path"] = np.array(path)
        finally:
            h5.h5py = h5py_module
    y = inp["y"]
    al = logger.AudioLogger(sr=8000, file_template=f"{work}/out/epoch={{epoch}}_p={{prompt_idx}}.wav")
    out["audio/path"] = np.array(al.write(y, epoch=3, prompt_idx=7))
    out["audio/torch_path"] = np.array(logger.AudioLogger(
        sr=8000, file_template=f"{work}/out/t{{epoch}}.wav").write(torch.from_numpy(y), epoch=1))
    out["audio/mp3_path"] = np.array(logger.AudioLogger(
        sr=8000, file_template=f"{work}/out/take_{{epoch}}.mp3").write(y, epoch=1))
    al.display(y, epoch=3, prompt_idx=7)
    try:
        al.to_numpy(np.zeros((2, 100, 3)))
        out["audio/multichannel"] = np.array("ran")
    except ValueError:
        out["audio/multichannel"] = np.array("ValueError")
    out["write_wav"] = np.array(audio_io.write_wav(f"{work}/loud.wav", 3 * y, 8000))
    for sr in (22050, 16000):
        out[f"load_audio/{sr}"] = audio_io.load_audio(str(inp["wav22"]), sr=sr)
    out["load_audio/offset"] = audio_io.load_audio(str(inp["wav22"]), sr=16000, offset=0.1,
                                                  duration=0.2)
    out["file_to_signal"] = mmk.FileToSignal(16000)(str(inp["wav22"]))
    out["file_to_signal/u8"] = mmk.FileToSignal(8000)(str(inp["wav_u8"]))
    grads = [t(g) for g in (inp["g0"], inp["g1"])]
    out["grad_norm"] = np.array([float(callbacks.GradNormCallback.grad_norm(grads, ord=o))
                                 for o in (1.0, 2.0, 3.0)])
    cb = callbacks.GradNormCallback()
    cb.on_after_backward(dict(a=grads[0], b=grads[1]))
    out["grad_norm/callback"] = np.array(cb.gradnorms)
    out["is_notebook"] = np.array(callbacks.is_notebook())
    return out


# -- monitored training -----------------------------------------------------------------------

def _pin_prompts(loop):
    """The generation callback's prompt positions drawn from RandomState(0),
    as the JAX side pins them."""
    for cb in loop.callbacks:
        if isinstance(cb, mmk.GenerateCallback):
            s_ = cb.loop.dataloader.sampler
            s_._rng = np.random.RandomState(0)
            s_.indices = s_.draw_indices(s_.N, s_._indices)


def train_monitor_task(inp: dict) -> dict:
    """The default ``TrainARMConfig()`` on a short dataset; an interrupted,
    monitored run resumed from its checkpoint (per-epoch losses, the loss
    log, the output files); three steps under each ``remat`` value against
    the plain run (f32 and bf16), with the LSTM forward's calls counted; the
    values ``remat`` refuses."""
    from unittest import mock

    from mimikit_tpu_torch.loops.train_loops import remat_context
    from mimikit_tpu_torch.ops import fused_lstm as fl

    torch.set_num_threads(1)
    work, out = str(inp["work"]), {}
    # the defaults (MONITOR_TRAINING on), on 0.6 s at 8 kHz
    ds8 = mmk.DatasetConfig(sources=(str(inp["wav8"]),), filename=f"{work}/short.h5",
                            extractors=(mmk.Extractor.signal(8000),))
    db8 = ds8.create(mode="w")
    io8 = mmk.IOSpec.mulaw_io(mmk.IOSpec.MuLawIOConfig(q_levels=32, mlp_dim=16),
                              extractor=ds8.extractors[0])
    net8 = mmk.SampleRNN.from_config(mmk.SampleRNN.Config(frame_sizes=(8, 4, 2), hidden_dim=16,
                                                          io_spec=io8), device="cpu")
    shown = []
    with mock.patch.object(mmk.AudioLogger, "display", lambda self, y, **kw: shown.append(kw)):
        loop = mmk.TrainARMLoop.from_config(mmk.TrainARMConfig(root_dir=f"{work}/default"), db8,
                                            net8)
        out["default/callbacks"] = np.array([type(cb).__name__ for cb in loop.callbacks])
        loop.run()
    out["default/losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
    out["default/shown"] = np.array([[kw["epoch"], kw["prompt_idx"]] for kw in shown])
    out["default/n_steps"] = np.array(loop.callbacks[1].loop.n_steps)

    # an interrupted, monitored run resumed from its checkpoint
    ds = mmk.DatasetConfig(sources=(str(inp["wav"]),), filename=str(inp["jax_h5"]),
                           extractors=(mmk.Extractor.signal(16000),))
    cfg = mmk.Config.deserialize(str(inp["train_yaml"]))
    cfg.root_dir = f"{work}/monitored"
    net_cfg = mmk.Config.deserialize(str(inp["net_yaml"]))
    net_cfg.io_spec.bind_to(ds)

    def fresh_net():
        net = mmk.SampleRNN.from_config(net_cfg, device="cpu")
        net.load_state_dict(mmk.samplernn_state_dict_from_jax(unflatten(inp, "params0/")))
        return net

    def stop(*_):
        raise KeyboardInterrupt

    first = mmk.TrainARMLoop.from_config(cfg, ds.get(mode="r"), fresh_net())
    _pin_prompts(first)
    first.on_train_epoch_end = stop
    first.run()
    resumed = mmk.TrainARMLoop.from_checkpoint(
        mmk.Checkpoint(first.hash_, 1, cfg.root_dir, device="cpu"))
    _pin_prompts(resumed)
    out["resume/start"] = np.array([resumed.start_epoch, resumed.global_step])
    resumed.run()
    out["resume/losses"] = np.array([h["loss"] for _, h in first.metrics.history]
                                    + [h["loss"] for _, h in resumed.metrics.history])
    run_dir = f"{cfg.root_dir}/{first.hash_}"
    out["resume/outputs"] = np.array(sorted(os.listdir(f"{run_dir}/outputs")))
    out["resume/log_path"] = np.array(f"{run_dir}/{cfg.trainer_kwargs['loss_logs_file']}")
    out["resume/end"] = np.array([resumed.global_step, resumed.opt.count])

    # remat: three steps under each value against the plain run, f32 and bf16
    rcfg = copy.deepcopy(cfg)
    rcfg.MONITOR_TRAINING, rcfg.OUTPUT_TRAINING = False, ""
    rcfg.trainer_kwargs.pop("loss_logs_file")

    def dots(ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy

        return (CheckpointPolicy.MUST_SAVE if op in (torch.ops.aten.mm.default,
                                                     torch.ops.aten.addmm.default)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    for dtype in ("float32", "bfloat16"):
        for name, remat in (("plain", False), ("true", True), ("dots_saveable", "dots_saveable"),
                            ("nothing_saveable", "nothing_saveable"),
                            ("everything_saveable", "everything_saveable"), ("callable", dots)):
            c = copy.deepcopy(rcfg)
            c.root_dir = f"{work}/remat_{dtype}_{name}"
            # a callable is no YAML: it goes to the loop after the config's True
            c.trainer_kwargs = {**c.trainer_kwargs, "remat": remat if name != "callable" else True}
            if dtype == "bfloat16":
                c.trainer_kwargs["param_dtype"] = "bfloat16"
            net = fresh_net()
            with _counting(fl, "lstm_forward") as calls:
                loop = mmk.TrainARMLoop.from_config(c, ds.get(mode="r"), net)
                if name == "callable":
                    loop.remat = remat_context(remat)
                loop.run()
            p = f"remat/{dtype}/{name}"
            out[p + "/calls"] = np.array([calls[0], loop.global_step])
            out[p + "/losses"] = np.array([h["loss"] for _, h in loop.metrics.history])
            out.update(_flax_flat(net.state_dict(), p + "/params/"))
    for name, remat in (("unknown", "offload_dot_with_no_batch_dims"), ("int", 3)):
        c = copy.deepcopy(rcfg)
        c.trainer_kwargs = {**c.trainer_kwargs, "remat": remat}
        try:
            mmk.TrainARMLoop.from_config(c, ds.get(mode="r"), fresh_net())
            out[f"remat/refused/{name}"] = np.array("ran")
        except (NotImplementedError, TypeError) as e:
            out[f"remat/refused/{name}"] = np.array(f"{type(e).__name__}: {e}")
    return out


TASKS = {"lstm_route": lstm_route_task, "lstm_wide_layout": lstm_wide_layout_task,
         "lstm_plan": lstm_plan_task, "xla_rsqrt": xla_rsqrt_task, "wavenet_cluster": wavenet_cluster_task, "modules": modules_task, "sample_rnn": sample_rnn_task, "fused_lstm": fused_lstm_task,
         "train": train_task, "train_stateless": train_stateless_task,
         "wavenet": wavenet_task, "categorical": categorical_task,
         "transformer": transformer_task, "jukebox": jukebox_task,
         "jukebox_cluster": jukebox_cluster_task, "samplernn_cluster": samplernn_cluster_task,
         "mulaw": mulaw_task, "bf16_decode": bf16_decode_task, "bf16_train": bf16_train_task,
         "bf16_train_stateless": bf16_train_stateless_task, "xla_dot": xla_dot_task,
         "temperature": temperature_task, "generate_loop": generate_loop_task,
         "loggers": loggers_task, "train_monitor": train_monitor_task}

if __name__ == "__main__":
    task, src, dst = sys.argv[1:4]
    with np.load(src, allow_pickle=False) as f:
        inputs = dict(f)
    np.savez(dst, **TASKS[task](inputs))
