"""chip_smoke.py's phase 8 (ensembles and the autoencoder) alone.

Usage, on a machine with one card: ``python3 tools/ensemble_phase.py``
(~1.5 min: the builds of the SampleRNN and WaveNet decode kernels and of the
LSTM kernels, then ~35 s).  It prints the card's name and power limit,
runs ``chip_smoke.ensemble_path`` (two checkpoints trained and reopened,
``demos.ensemble_generator`` over four events on K1 and K4 with every
event's tokens checked, ``Resample`` on the card, ``TiedAE`` with
``EncodeDecodeLoop``, MelSpec/MFCC/Chroma) and its wall time, and exits
non-zero where a check fails.
"""
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ensemble_phase: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mimikit_tpu_torch as mmk
    from mimikit_tpu_torch.ops import fused_lstm as fl
    from mimikit_tpu_torch.ops import samplernn_decode as sd
    from mimikit_tpu_torch.ops import wavenet_decode as wd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t = time.perf_counter()
    builds = (sd.build_kernel, sd.build_cluster_kernel, fl.build_lstm_kernel, wd.build_kernel,
              wd.build_cluster_kernel)
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per source, started together
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"builds {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(cs.ensemble_path(torch, mmk, fl, sd, wd, card))
    print(f"phase 8 took {time.perf_counter() - t:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
