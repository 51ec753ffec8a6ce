"""LSTM layer over time for training: hand-written CUDA kernels, their
wrappers and their plain PyTorch versions.

The kernels (``csrc/fused_lstm.cu``) replace the TPU kernels of
``mimikit_tpu/ops/pallas_lstm.py:76`` ``_make_fused_calls``: the forward
(K3a, ``pallas_call`` at :111) and the backward (K3b, :197).  What bounds
them on an H100 and what their design does about it is in the source note at
the top of the ``.cu`` file.

* :func:`lstm_forward` ``(xi, Wh, h0, c0) -> (h_all, c_all, gates)``;
* :func:`lstm_backward` ``(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0,
  Wh) -> (dxi, dWh, dh0, dc0)``;
* :func:`fused_lstm_layer` ``(x, Wi, Wh, b, h0, c0) -> (h_all, h_T, c_T)``,
  the layer as ``pallas_lstm.fused_lstm_layer`` has it (time-major, gate
  order i|f|g|o, ``Wi`` (D, 4H), ``Wh`` (H, 4H)), differentiable in every
  argument through a ``torch.autograd.Function`` whose backward is the
  backward kernel.  ``xi = x @ Wi + b`` and ``db``, ``dWi``, ``dx`` from
  ``dxi`` are products outside the kernels, as in ``pallas_lstm.py:245-277``.

The wrappers' rule: a CPU tensor takes the plain version
(:func:`lstm_forward_plain`, :func:`lstm_backward_plain`, step loops that
mirror the kernels' arithmetic); a CUDA tensor launches the kernel or raises.
Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .nvcc import CSRC, build_library

__all__ = [
    "lstm_forward_plain",
    "lstm_backward_plain",
    "lstm_forward",
    "lstm_backward",
    "fused_lstm_layer",
    "lstm_kernel_rows",
    "build_lstm_kernel",
]

SOURCE = CSRC / "fused_lstm.cu"
CLUSTER = 8       # blocks of a thread block cluster: each owns H/8 hidden units
THREADS = 256     # threads of a block
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on sm_90
_ROW_GROUPS = (1, 2, 4, 8)
_MAX_CLUSTERS = 8  # groups of batch rows that run at once with room to spare


# -- plain versions ---------------------------------------------------------------

def lstm_forward_plain(xi: torch.Tensor, Wh: torch.Tensor, h0: torch.Tensor,
                       c0: torch.Tensor):
    """The forward kernel's arithmetic as a PyTorch step loop
    (``pallas_lstm.py:95-109``).  xi (T, B, 4H); returns h_all, c_all
    (T, B, H) and the post-activation gates (T, B, 4H)."""
    H = Wh.shape[0]
    h, c = h0, c0
    hs, cs, gs = [], [], []
    for t in range(xi.shape[0]):
        z = xi[t] + h @ Wh
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H : 2 * H])
        g = torch.tanh(z[:, 2 * H : 3 * H])
        o = torch.sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=1))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh):
    """The backward kernel's arithmetic as a reverse-time PyTorch loop,
    written out as ``bwd_kernel`` is (``pallas_lstm.py:143-195``), with
    ``dWh`` summed step by step.  Returns dxi (T, B, 4H), dWh (H, 4H), dh0,
    dc0 (B, H)."""
    T, B, H = c_all.shape
    dh_c, dc_c = dh_T, dc_T
    dWh = torch.zeros_like(Wh)
    dxi = torch.empty_like(gates)
    for t in range(T - 1, -1, -1):
        dh = dh_all[t] + dh_c
        i, f, g, o = gates[t].split(H, dim=1)
        tc = torch.tanh(c_all[t])
        do = dh * tc
        dc = dc_c + dh * o * (1.0 - tc * tc)
        c_prev = c_all[t - 1] if t > 0 else c0
        dz = torch.cat([
            dc * g * i * (1.0 - i),
            dc * c_prev * f * (1.0 - f),
            dc * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=1)
        dxi[t] = dz
        dh_c = dz @ Wh.t()
        dc_c = dc * f
        h_prev = h_all[t - 1] if t > 0 else h0
        dWh += h_prev.t() @ dz
    return dxi, dWh, dh_c, dc_c


# -- the kernels: scope, build, bind, launch ------------------------------------------

def _fwd_smem(H: int, rows: int) -> int:
    """Bytes of shared memory of the forward kernel (``fwd_smem`` in the .cu)."""
    U = H // CLUSTER
    NC = 4 * U
    return 4 * (H * NC + rows * H + 2 * rows * U + (THREADS // NC) * rows * NC)


def _bwd_smem(H: int, rows: int) -> int:
    """Bytes of shared memory of the backward kernel (``bwd_smem`` in the .cu)."""
    U = H // CLUSTER
    NC = 4 * U
    return 4 * (4 * H * U + rows * 4 * H + 2 * rows * NC + (THREADS // U) * rows * U)


def lstm_kernel_rows(B: int, H: int) -> int:
    """Batch rows per cluster for the kernels at (B, H): the fewest that keep
    the clusters to at most 8 (64 SMs), within the kernels' limits.  Raises
    ``ValueError`` outside the scope: H must be a multiple of 8 and the Wh
    slice plus buffers must fit a block's shared memory (up to H = 328)."""
    if B < 1 or H < CLUSTER or H % CLUSTER:
        raise ValueError(f"the LSTM kernels need B >= 1 and H a multiple of 8, got B={B}, H={H}")
    U = H // CLUSTER
    fits = [
        r for r in _ROW_GROUPS
        if 4 * U <= THREADS and r * U <= THREADS
        and max(_fwd_smem(H, r), _bwd_smem(H, r)) <= SMEM_PER_BLOCK
    ]
    if not fits:
        raise ValueError(f"H={H} exceeds the LSTM kernels' shared-memory budget (H <= 328)")
    for r in fits:
        if -(-B // r) <= _MAX_CLUSTERS:
            return r
    return fits[-1]


def dwh_splits(R: int, H: int) -> int:
    """Row ranges the dWh product splits its R = T*B rows into: enough for
    about 512 blocks of 64 x 64 tiles (several per SM), each range at least
    256 rows."""
    tiles = -(-H // 64) * -(-4 * H // 64)
    return max(1, min(R // 256, -(-512 // tiles)))


class _Kernel:
    """The built library (one per process) and its compiler output."""

    lib = None
    build_log = ""


def build_lstm_kernel() -> Path:
    """Compile ``csrc/fused_lstm.cu`` for sm_90a into ``build/kernels/``
    and return the library's path."""
    path, log = build_library(SOURCE, "mmk_fused_lstm")
    if log:
        _Kernel.build_log = log
    return path


def _library():
    if _Kernel.lib is None:
        lib = ctypes.CDLL(str(build_lstm_kernel()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mmk_lstm_forward.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.mmk_lstm_forward.restype = i
        lib.mmk_lstm_backward.argtypes = [p] * 14 + [i] * 5 + [p]
        lib.mmk_lstm_backward.restype = i
        for fn in (lib.mmk_lstm_fwd_smem, lib.mmk_lstm_bwd_smem):
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_longlong
        lib.mmk_lstm_error_string.argtypes = [i]
        lib.mmk_lstm_error_string.restype = ctypes.c_char_p
        for H, r in ((256, 4), (16, 1)):
            if (lib.mmk_lstm_fwd_smem(H, r), lib.mmk_lstm_bwd_smem(H, r)) != (
                _fwd_smem(H, r), _bwd_smem(H, r)
            ):
                raise RuntimeError("the LSTM kernels' shared-memory sizes differ between C and Python")
        _Kernel.lib = lib
    return _Kernel.lib


def _check(x: torch.Tensor, name: str, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}; the LSTM kernels take float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().mmk_lstm_error_string(err).decode()}")


def lstm_forward(xi: torch.Tensor, Wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
    """K3a: the recurrence over xi (T, B, 4H) from (h0, c0) (B, H) with Wh
    (H, 4H).  Returns h_all, c_all (T, B, H) and gates (T, B, 4H)."""
    if xi.device.type == "cpu":
        return lstm_forward_plain(xi, Wh, h0, c0)
    T, B, H4 = xi.shape
    H = Wh.shape[0]
    dev = xi.device
    rows = lstm_kernel_rows(B, H)
    if T < 1 or H4 != 4 * H:
        raise ValueError(f"xi has shape {tuple(xi.shape)}, expected (T >= 1, B, {4 * H})")
    for x, name, shape in ((xi, "xi", (T, B, H4)), (Wh, "Wh", (H, H4)),
                           (h0, "h0", (B, H)), (c0, "c0", (B, H))):
        _check(x, name, shape, dev)
    lib = _library()
    h_all = torch.empty(T, B, H, device=dev)
    c_all = torch.empty(T, B, H, device=dev)
    gates = torch.empty(T, B, H4, device=dev)
    err = lib.mmk_lstm_forward(
        xi.data_ptr(), Wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), h_all.data_ptr(),
        c_all.data_ptr(), gates.data_ptr(), T, B, H, rows,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "LSTM forward kernel")
    lstm_forward.launches += 1
    return h_all, c_all, gates


def lstm_backward(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh):
    """K3b: the reverse-time walk and dWh.  Returns dxi (T, B, 4H), dWh
    (H, 4H), dh0 and dc0 (B, H)."""
    if gates.device.type == "cpu":
        return lstm_backward_plain(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, Wh)
    T, B, H = c_all.shape
    dev = gates.device
    rows = lstm_kernel_rows(B, H)
    for x, name, shape in (
        (dh_all, "dh_all", (T, B, H)), (dh_T, "dh_T", (B, H)), (dc_T, "dc_T", (B, H)),
        (gates, "gates", (T, B, 4 * H)), (c_all, "c_all", (T, B, H)),
        (h_all, "h_all", (T, B, H)), (h0, "h0", (B, H)), (c0, "c0", (B, H)),
        (Wh, "Wh", (H, 4 * H)),
    ):
        _check(x, name, shape, dev)
    lib = _library()
    dxi = torch.empty(T, B, 4 * H, device=dev)
    dWh = torch.empty(H, 4 * H, device=dev)
    dh0 = torch.empty(B, H, device=dev)
    dc0 = torch.empty(B, H, device=dev)
    splits = dwh_splits(T * B, H)
    part = torch.empty(splits, H, 4 * H, device=dev) if splits > 1 else dWh
    err = lib.mmk_lstm_backward(
        dh_all.data_ptr(), dh_T.data_ptr(), dc_T.data_ptr(), gates.data_ptr(),
        c_all.data_ptr(), h_all.data_ptr(), h0.data_ptr(), c0.data_ptr(), Wh.data_ptr(),
        dxi.data_ptr(), dWh.data_ptr(), part.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        T, B, H, rows, splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "LSTM backward kernel")
    lstm_backward.launches += 1
    return dxi, dWh, dh0, dc0


lstm_forward.launches = 0
lstm_backward.launches = 0


# -- the layer ---------------------------------------------------------------------------

def _materialize(ct: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Outputs the loss does not use come back as None: zeros instead
    (``pallas_lstm.py:280-286``)."""
    return torch.zeros_like(like) if ct is None else ct.contiguous()


class _FusedLSTMLayer(torch.autograd.Function):
    """The layer with the kernels' backward (``pallas_lstm.py:239-289``)."""

    @staticmethod
    def forward(ctx, x, Wi, Wh, b, h0, c0):
        T, B, D = x.shape
        xi = torch.addmm(b, x.reshape(T * B, D), Wi).reshape(T, B, -1)
        h_all, c_all, gates = lstm_forward(xi, Wh, h0, c0)
        ctx.save_for_backward(x, Wi, Wh, h0, c0, h_all, c_all, gates)
        ctx.set_materialize_grads(False)
        return h_all, h_all[-1].clone(), c_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dh_T, dc_T):
        x, Wi, Wh, h0, c0, h_all, c_all, gates = ctx.saved_tensors
        T, B, D = x.shape
        dxi, dWh, dh0, dc0 = lstm_backward(
            _materialize(dh_all, h_all), _materialize(dh_T, h0), _materialize(dc_T, c0),
            gates, c_all, h_all, h0, c0, Wh,
        )
        dxi2 = dxi.reshape(T * B, -1)
        need = ctx.needs_input_grad
        dx = (dxi2 @ Wi.t()).reshape(T, B, D) if need[0] else None
        dWi = x.reshape(T * B, D).t() @ dxi2 if need[1] else None
        db = dxi2.sum(0) if need[3] else None
        return dx, dWi, dWh, db, dh0, dc0


def fused_lstm_layer(x: torch.Tensor, Wi: torch.Tensor, Wh: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One LSTM layer over time.  x (T, B, D) time-major; Wi (D, 4H), Wh
    (H, 4H), b (4H,) in gate order i|f|g|o; h0, c0 (B, H).  Returns
    ``(h_all (T, B, H), h_T, c_T)``, differentiable in every argument.  On
    CUDA tensors the kernels run, or the call raises (outside their scope:
    see :func:`lstm_kernel_rows`); on CPU tensors the plain versions run."""
    if x.dim() != 3 or Wh.dim() != 2 or Wh.shape[1] != 4 * Wh.shape[0]:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, Wh {tuple(Wh.shape)}")
    return _FusedLSTMLayer.apply(
        x.contiguous(), Wi, Wh.contiguous(), b, h0.contiguous(), c0.contiguous()
    )
