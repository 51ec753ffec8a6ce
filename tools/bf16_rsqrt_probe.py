"""XLA's CPU rsqrt, and what it does to the transformers' bf16 training gaps.

Usage, on the CPU with gcc, from the root of a checkout (~4 min):
``python tools/bf16_rsqrt_probe.py``.  XLA's CPU backend lowers f32 ``rsqrt``
to the x86 approximation (``rsqrtps``/``rsqrtss``, ~12 bits) refined by two
Newton steps whose ``a b + c`` LLVM fuses (``y' = fma(-y / 2, fma(x y, y,
-1), y)``).  The script builds that (the approximation from
``_mm256_rsqrt_ps``) into ``build/rsqrt_probe/`` and prints:

* how often it, ``torch.rsqrt`` and the correctly rounded value part from
  ``jax.jit(jax.lax.rsqrt)`` over 1M f32 values in [1e-4, 10];
* each stateless net's bf16 step gaps (|port - JAX bf16| / |JAX bf16 - JAX
  f32|, as ``tools/bf16_train_gaps.py``) with the port as it is and with
  ``torch.rsqrt`` replaced by that emulation on CPU tensors (the layer
  norm's only rsqrt, ``modules/rounding.py``).

The emulation is a probe: it needs the CPU's own approximation, which
PyTorch does not expose.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "build", "rsqrt_probe")
C_SRC = r"""
#include <immintrin.h>
void rsqrt_approx(const float* x, float* y, long n) {
  long i = 0;
  for (; i + 8 <= n; i += 8) _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
  for (; i < n; ++i) y[i] = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x[i])));
}
"""
KINDS = "transformer,jukebox"


def build() -> str:
    os.makedirs(WORK, exist_ok=True)
    src, lib = os.path.join(WORK, "rsqrt.c"), os.path.join(WORK, "librsqrt.so")
    with open(src, "w") as f:
        f.write(C_SRC)
    subprocess.run(["gcc", "-O2", "-mavx", "-shared", "-fPIC", "-o", lib, src], check=True)
    return lib


def xla_rsqrt_np(x: np.ndarray, lib: str) -> np.ndarray:
    import ctypes

    so = ctypes.CDLL(lib)
    x = np.ascontiguousarray(x, np.float32)
    y0 = np.empty_like(x)
    so.rsqrt_approx(x.ctypes.data_as(ctypes.c_void_p), y0.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_long(x.size))

    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)

    y = y0
    for _ in range(2):
        y = fma((y * np.float32(-0.5)).astype(np.float32),
                fma((x * y).astype(np.float32), y, np.float32(-1)), y)
    return np.where(np.isfinite(x) & (x != 0), y, y0)


def port_side(src: str, dst: str, lib: str, patch: bool) -> None:
    """The port's bf16 loops (``torch_port_worker.bf16_train_stateless``),
    with ``torch.rsqrt`` on CPU f32 tensors replaced when ``patch``."""
    import torch

    if patch:
        plain = torch.rsqrt

        def rsqrt(x):
            if x.device.type != "cpu" or x.dtype != torch.float32:
                return plain(x)
            return torch.from_numpy(xla_rsqrt_np(x.detach().numpy(), lib)).reshape(x.shape)

        torch.rsqrt = rsqrt
    from tests.torch_port_worker import bf16_train_stateless_task

    with np.load(src, allow_pickle=False) as f:
        inp = dict(f)
    np.savez(dst, **bf16_train_stateless_task(inp))


def main() -> int:
    if sys.argv[1:2] == ["--port"]:
        port_side(sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5] == "1")
        return 0
    lib = build()
    x = np.random.default_rng(0).uniform(1e-4, 10, 1_000_000).astype(np.float32)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ref = os.path.join(tmp, "rsqrt.npy")
        subprocess.run([sys.executable, "-c",
                        "import sys, numpy as np, jax; jax.config.update('jax_platforms', 'cpu');"
                        f"x = np.random.default_rng(0).uniform(1e-4, 10, 1_000_000)"
                        f".astype(np.float32); np.save({ref!r}, np.asarray("
                        "jax.jit(jax.lax.rsqrt)(x)))"], check=True, env=env)
        import torch

        j = np.load(ref)
        emu = xla_rsqrt_np(x, lib)
        cr = (1 / np.sqrt(x.astype(np.float64))).astype(np.float32)
        tr = torch.rsqrt(torch.from_numpy(x)).numpy()
        print(f"jax.jit(jax.lax.rsqrt) against: the emulation {(emu != j).mean():.4%} of 1M"
              f" values differ, torch.rsqrt {(tr != j).mean():.4%}, the correctly rounded"
              f" value {(cr != j).mean():.4%}", flush=True)
        path = os.path.join(tmp, "jax.npz")
        subprocess.run([sys.executable, os.path.join(ROOT, "tests", "test_torch_bf16_train.py"),
                        "stateless", path, tmp, KINDS], check=True, env=env, cwd=ROOT,
                       capture_output=True)
        with np.load(path, allow_pickle=False) as f:
            inp = dict(f)
        for patch in (0, 1):
            out = os.path.join(tmp, f"port{patch}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--port", path, out, lib,
                            str(patch)], check=True, env=dict(os.environ, PYTHONPATH=ROOT),
                           cwd=ROOT, capture_output=True)
            with np.load(out) as f:
                port = dict(f)
            for kind in KINDS.split(","):
                j16, j32 = inp[f"{kind}/jax_losses/bfloat16"], inp[f"{kind}/jax_losses/float32"]
                share = np.abs(port[f"{kind}/losses"] - j16) / np.abs(j16 - j32)
                print(f"{kind}, {'XLA rsqrt' if patch else 'torch.rsqrt'}: each step's |port -"
                      f" JAX bf16| / |JAX bf16 - JAX f32| = "
                      f"{np.array2string(share, precision=4)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
