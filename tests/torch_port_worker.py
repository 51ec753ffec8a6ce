"""Port side of the ``tests/test_torch_*.py`` parity tests.

Run as ``python tests/torch_port_worker.py <task> <in.npz> <out.npz>``.  It
imports only ``torch``, numpy and ``mimikit_tpu_torch`` — never jax nor
``mimikit_tpu``, which the calling test process has loaded (the two
frameworks are kept in separate processes).  Every test module runs one
worker process for all of its cases and exchanges arrays through ``.npz``:
JAX parameter trees travel flattened with ``/``-joined keys.
"""
import os
import sys

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


TASKS = {"modules": modules_task, "sample_rnn": sample_rnn_task}

if __name__ == "__main__":
    task, src, dst = sys.argv[1:4]
    with np.load(src, allow_pickle=False) as f:
        inputs = dict(f)
    np.savez(dst, **TASKS[task](inputs))
