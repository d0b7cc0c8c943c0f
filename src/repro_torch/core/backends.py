"""Pluggable conv compute backends for the distributed engine.

The paper distributes ONE operation — the stride-1 SAME convolution over
the output-channel ("kernel") axis — so every device in the cluster only
ever needs two primitives:

    conv(x, w)        -> y                (Algorithm 2's `convn`)
    conv_vjp(x, w, g) -> (dx, dw)         (the backward shard)

``ConvBackend`` pins that contract; the registry maps a name to an
implementation so a heterogeneous cluster can mix devices running
different kernels (the paper's CPU/GPU scenario):

    numpy   — serial im2col, thread-safe everywhere; the master's
              default.
    cuda    — the hand-written Hopper kernels on a CUDA device: the
              forward conv (kernels/csrc/conv2d_fwd.cu) and its dX and
              dW (kernels/csrc/conv2d_bwd.cu); the counterpart of the
              JAX package's ``pallas`` backend.
    torch   — the plain PyTorch version (kernels/ref.py) on a named
              device (``torch:cpu``, ``torch:cuda``), with an autograd
              VJP: the reference the tests run the protocol on.

Every primitive takes and returns **numpy** arrays: the master/slave
protocol moves serialized host buffers (the emulated sockets), and numpy
is the one currency every backend speaks.  A backend that computes on a
torch device (``device``; None for ``numpy`` and ``sim``) also takes
tensors already on that device and returns tensors there: the master's
own shard of a training step, whose operands stay on the card.  ``seam``
is the one move between the host's numpy and a torch device.
``probe_conv_time`` times the SAME code a device will run for the real
workload, so the Eq. 1 shares computed from probe times are exact per
backend.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import spans


class ConvBackend:
    """The per-device compute contract of the distributed conv engine."""

    name: str = "base"
    device = None  # the torch device it computes on; None: numpy only

    def conv(self, x: np.ndarray, w: np.ndarray) -> np.ndarray:
        """NHWC x HWIO -> NHWC, SAME padding, stride 1."""
        raise NotImplementedError

    def conv_vjp(
        self, x: np.ndarray, w: np.ndarray, g: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dx, dw) of sum(conv(x, w) * g)."""
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[..., ConvBackend]] = {}
_INSTANCES: Dict[str, ConvBackend] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("mine")`` adds a factory."""

    def deco(factory: Callable[..., ConvBackend]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_backend(name: str) -> ConvBackend:
    """Resolve (and cache) a backend instance by registry name.

    Names may carry a parameter after a colon — ``"sim:5e9"`` is a sim
    device at 5 GFLOP/s, ``"torch:cuda"`` runs the plain conv on the card —
    so one cluster can mix several instances of the same backend at
    different speeds without the per-device ``slowdown`` workaround.
    Each parameterized name caches its OWN instance."""
    if name not in _INSTANCES:
        base, _, param = name.partition(":")
        if base not in _REGISTRY:
            raise KeyError(
                f"unknown conv backend {name!r}; available: {available_backends()}"
            )
        try:
            _INSTANCES[name] = _REGISTRY[base](param) if param else _REGISTRY[base]()
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"backend {base!r} rejected parameter {param!r}: {e}"
            ) from e
    return _INSTANCES[name]


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# numpy: serial im2col — the seed implementation, kept as the reference
# and as the master's default.
# ---------------------------------------------------------------------------


def _conv_windows(x: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """SAME-padded sliding windows as a zero-copy strided VIEW.
    x: (B,H,W,C) -> view (B,H,W,C,kh,kw)."""
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x, ((0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw), (0, 0)))
    return np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(1, 2))


def _im2col(x: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """SAME-padded im2col.  x: (B,H,W,C) -> (B,H,W, kh*kw*C).

    Materializes a contiguous copy of the windows — kept ONLY where the
    reshape-to-matrix genuinely requires it: for kh,kw > 1 the single
    large BLAS GEMM it enables beats every measured copy-free
    formulation (tensordot/einsum on the strided view re-materialize the
    same copy internally; per-tap shifted GEMMs lose to the strided
    accumulate), and the VJP's ``cols.T @ g`` has no matrix without it.
    The 1x1 forward skips the lowering entirely (see ``numpy_conv``)."""
    b, h, w, c = x.shape
    win = _conv_windows(x, kh, kw).transpose(0, 1, 2, 4, 5, 3)
    return np.ascontiguousarray(win).reshape(b, h, w, kh * kw * c)


def numpy_conv(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """NHWC x HWIO SAME conv, stride 1 (the slave's `convn`).

    1x1 kernels take the lowering-free hot path: one GEMM on a FREE
    reshape of the contiguous input — no pad, no window copy (1.4-17x
    measured, ``numpy_fwd_1x1_nocopy`` in bench_kernels).  Larger
    kernels keep the im2col copy the GEMM genuinely needs (see
    ``_im2col``)."""
    kh, kw, cin, cout = w.shape
    x = np.asarray(x, np.float32)
    if kh == 1 and kw == 1:
        b, h, wd, _ = x.shape
        return (x.reshape(-1, cin) @ w[0, 0]).reshape(b, h, wd, cout)
    cols = _im2col(x, kh, kw)
    y = cols.reshape(-1, kh * kw * cin) @ w.reshape(kh * kw * cin, cout)
    return y.reshape(x.shape[0], x.shape[1], x.shape[2], cout)


def numpy_conv_vjp(x: np.ndarray, w: np.ndarray, g: np.ndarray):
    """Returns (dx, dw) of sum(conv(x, w) * g)."""
    x = np.asarray(x, np.float32)
    g = np.asarray(g, np.float32)
    kh, kw, cin, cout = w.shape
    if cout == 0:  # legal: a device allocated 0 kernels contributes nothing
        return np.zeros(x.shape, np.float32), np.zeros(w.shape, np.float32)
    b, h, wd, _ = x.shape
    cols = _im2col(x, kh, kw).reshape(-1, kh * kw * cin)
    dw = (cols.T @ g.reshape(-1, cout)).reshape(kh, kw, cin, cout)
    # dx: scatter the columns of dG @ W^T back into the padded image
    dcols = (g.reshape(-1, cout) @ w.reshape(kh * kw * cin, cout).T).reshape(
        b, h, wd, kh, kw, cin
    )
    ph, pw = kh // 2, kw // 2
    dxp = np.zeros((b, h + kh - 1, wd + kw - 1, cin), np.float32)
    for di in range(kh):
        for dj in range(kw):
            dxp[:, di : di + h, dj : dj + wd, :] += dcols[:, :, :, di, dj, :]
    dx = dxp[:, ph : ph + h, pw : pw + wd, :]
    return dx, dw


@register_backend("numpy")
class NumpyBackend(ConvBackend):
    name = "numpy"

    def conv(self, x, w):
        return numpy_conv(x, w)

    def conv_vjp(self, x, w, g):
        return numpy_conv_vjp(x, w, g)


# ---------------------------------------------------------------------------
# height-strip (spatial) partitioning helpers — shared by the master and
# every slave, on top of ANY backend's plain SAME conv primitives.
# ---------------------------------------------------------------------------


def strip_conv(
    backend: ConvBackend,
    x_halo: np.ndarray,
    w: np.ndarray,
    pad_top: int,
    pad_bot: int,
) -> np.ndarray:
    """Forward of one height strip of a SAME stride-1 conv.

    ``x_halo`` holds the strip's input rows plus the ``kh//2`` halo rows
    on each side, CLIPPED at the image border; ``pad_top``/``pad_bot``
    zero-rows restore what the clip removed, so the padded strip carries
    exactly the receptive field of the strip's output rows (the zeros
    coincide with the global SAME padding).  Runs the backend's ordinary
    SAME conv on the padded strip and slices out the interior rows —
    every backend works unchanged.  Assumes odd ``kh`` (the repo's
    ``kh//2``-low padding convention; even kernels differ per backend).
    Returns the strip's output rows: (B, strip_h, W, cout)."""
    kh = w.shape[0]
    ph = kh // 2
    strip_h = x_halo.shape[1] + pad_top + pad_bot - (kh - 1)
    if strip_h <= 0:  # a device legally allocated 0 rows
        return np.zeros(
            (x_halo.shape[0], 0, x_halo.shape[2], w.shape[-1]), np.float32
        )
    xp = np.pad(x_halo, ((0, 0), (pad_top, pad_bot), (0, 0), (0, 0)))
    y = backend.conv(xp, w)
    return np.asarray(y[:, ph : ph + strip_h], np.float32)


def strip_conv_vjp(
    backend: ConvBackend,
    x_halo: np.ndarray,
    w: np.ndarray,
    g_strip: np.ndarray,
    pad_top: int,
    pad_bot: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Backward of one height strip: ``(dx_halo, dw_partial)``.

    ``dx_halo`` covers the strip PLUS its halo rows — contributions of
    this strip's output-gradient rows to neighbouring strips' inputs —
    so the master must overlap-ADD the seams when reassembling the full
    dX.  ``dw_partial`` is this strip's contribution to the FULL kernel
    gradient (strips see every output channel); the master sums it."""
    kh = w.shape[0]
    ph = kh // 2
    strip_h = g_strip.shape[1]
    if strip_h == 0 or x_halo.shape[1] == 0:
        return (
            np.zeros(x_halo.shape, np.float32),
            np.zeros(w.shape, np.float32),
        )
    xp = np.pad(x_halo, ((0, 0), (pad_top, pad_bot), (0, 0), (0, 0)))
    gp = np.zeros(xp.shape[:-1] + (w.shape[-1],), np.float32)
    gp[:, ph : ph + strip_h] = g_strip
    dxp, dw = backend.conv_vjp(xp, w, gp)
    dx_halo = dxp[:, pad_top : pad_top + x_halo.shape[1]]
    return np.asarray(dx_halo, np.float32), np.asarray(dw, np.float32)


# ---------------------------------------------------------------------------
# cuda: the hand-written Hopper kernel; torch: its plain PyTorch version.
# ---------------------------------------------------------------------------


def is_tensor(a) -> bool:
    """Whether ``a`` is a torch tensor, without importing torch (a numpy
    slave process never loads it)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def _moved(a, device):
    import torch

    if device is None:
        return a.detach().to(torch.float32).contiguous().cpu().numpy()
    if is_tensor(a):
        return a.detach().to(device, torch.float32)
    a = np.ascontiguousarray(a, np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def seam(device, name: Optional[str] = None, **operands):
    """The operands where ``device`` says: float32 tensors on ``device``,
    or with ``device`` None float32 numpy arrays on the host, C-contiguous
    where they moved.  An operand already there passes as it is.  Each
    operand that moves crosses the seam between the host's numpy and a
    torch device: a tensor's stream is drained first, so that the span
    ``name`` (where given, and where any bytes move) is the copies alone,
    with their bytes by keyword.  One operand returns alone, several as a
    tuple in their order."""
    if device is None:
        out = {k: a if is_tensor(a) else np.asarray(a, np.float32)
               for k, a in operands.items()}
        moving = [k for k, a in out.items() if is_tensor(a)]
        for k in moving:
            drain(out[k])
    else:
        import torch

        device = torch.device(device)
        out = dict(operands)
        # a tensor on ``device`` stays (``cuda`` with no index: on any card)
        moving = [k for k, a in out.items() if not (
            is_tensor(a) and a.dtype == torch.float32 and a.device.type == device.type
            and device.index in (None, a.device.index))]
    nbytes = {k: 4 * int(np.prod(out[k].shape)) for k in moving}
    nbytes = {k: n for k, n in nbytes.items() if n}
    with (spans.span(name, nbytes) if name and nbytes else contextlib.nullcontext()):
        for k in moving:
            out[k] = _moved(out[k], device)
    vals = tuple(out.values())
    return vals[0] if len(vals) == 1 else vals


def concat(parts, axis: int):
    """``parts`` joined along ``axis``: numpy arrays by
    ``np.concatenate``, tensors by ``torch.cat`` (a lone tensor as it
    is)."""
    if not is_tensor(parts[0]):
        return np.concatenate(parts, axis=axis)
    if len(parts) == 1:
        return parts[0]
    import torch

    return torch.cat(parts, dim=axis)


def drain(t) -> None:
    """Waits for the work queued on the card's current stream before
    tensor ``t`` is copied to the host.  The copy would wait anyway;
    waiting first leaves the copy's span the copy alone.  A CPU tensor
    is never waited on."""
    if t.is_cuda:
        import torch

        torch.cuda.current_stream(t.device).synchronize()


def _cuda_device(index: int = 0):
    """``torch.device("cuda", index)``, or a clear error when there is no
    card: a device asked to run on CUDA never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False.  The "
            "'cuda' backend runs only on the card and never falls back; "
            "use 'numpy' or 'torch:cpu' for a CPU device"
        )
    return torch.device("cuda", index)


@register_backend("cuda")
class CudaBackend(ConvBackend):
    """Runs the hand-written conv kernels (kernels/conv2d.py) on a CUDA
    device: ``conv2d`` forward, ``conv2d_dx`` and ``conv2d_dw`` backward.
    Numpy operands are copied to the card and the results back; tensors
    on the card (contiguous, as the kernels read them) are computed on
    where they are and the results stay there.  The kernels are built
    here, at construction, so a missing ``nvcc`` or a failed build
    raises before any slave thread starts.

    While a torch profiler records, each call is up to three spans
    (``core/spans.py``): ``cuda.to_card`` (the bytes of the operands that
    crossed, by name: ``x``, ``w``, ``g``), ``cuda.compute`` (the
    launches up to the stream's drain; label ``operands``: ``host`` for
    numpy operands, ``card`` for tensors) and ``cuda.to_host`` (``y``,
    or ``dx`` and ``dw``, for numpy operands).  The drain runs traced or
    not: a copy back would wait for the kernels anyway, and the
    cluster's timing of the master's shard reads it."""

    name = "cuda"

    def __init__(self):
        from repro_torch.kernels._build import (
            conv2d_bwd_library,
            conv2d_fwd_library,
        )

        self.device = _cuda_device()
        conv2d_fwd_library()
        conv2d_bwd_library()

    def conv(self, x, w):
        from repro_torch.kernels.conv2d import conv2d

        host = not is_tensor(x)
        xt, wt = seam(self.device, "cuda.to_card", x=x, w=w)
        with spans.span("cuda.compute", operands="host" if host else "card"):
            y = conv2d(xt, wt)
            drain(y)
        return seam(None, "cuda.to_host", y=y) if host else y

    def conv_vjp(self, x, w, g):
        from repro_torch.kernels.conv2d import conv2d_dw, conv2d_dx

        host = not is_tensor(x)
        xt, wt, gt = seam(self.device, "cuda.to_card", x=x, w=w, g=g)
        with spans.span("cuda.compute", operands="host" if host else "card"):
            dx = conv2d_dx(gt, wt)
            dw = conv2d_dw(xt, gt, wt.shape[0], wt.shape[1])
            drain(dw)
        return seam(None, "cuda.to_host", dx=dx, dw=dw) if host else (dx, dw)


@register_backend("torch")
class TorchBackend(ConvBackend):
    """The plain PyTorch conv (kernels/ref.py) on a named device —
    ``torch`` / ``torch:cpu`` (the default) or ``torch:cuda``; its VJP
    is autograd of the same arithmetic.  Numpy in, numpy out; tensors on
    its device in, tensors out."""

    name = "torch"

    def __init__(self, device="cpu"):
        import torch

        dev = torch.device(device)
        self.device = _cuda_device(dev.index or 0) if dev.type == "cuda" else dev

    def _tensor(self, a, grad: bool = False):
        return seam(self.device, a=a).detach().requires_grad_(grad)

    def conv(self, x, w):
        import torch

        from repro_torch.kernels.ref import conv2d_ref

        with torch.no_grad():
            y = conv2d_ref(self._tensor(x), self._tensor(w))
        return y if is_tensor(x) else seam(None, y=y)

    def conv_vjp(self, x, w, g):
        import torch

        from repro_torch.kernels.ref import conv2d_ref, ieee_fp32_matmul

        # the backward's matmuls too run in IEEE float32 on the card
        with torch.enable_grad(), ieee_fp32_matmul(self.device):
            xt, wt = self._tensor(x, True), self._tensor(w, True)
            dx, dw = torch.autograd.grad(
                conv2d_ref(xt, wt), (xt, wt), self._tensor(g)
            )
        return (dx, dw) if is_tensor(x) else seam(None, dx=dx, dw=dw)


# ---------------------------------------------------------------------------
# sim: a deterministic virtual device for protocol/scheduling studies.
# ---------------------------------------------------------------------------


@register_backend("sim")
class SimBackend(ConvBackend):
    """Sleeps exactly ``flops / flops_per_s`` and returns ZEROS of the
    right shape.  Wall-clock behaves like a device of known speed with
    none of the host's compute noise — for benchmarking the master/slave
    protocol schedule (bench_master_slave.py), NEVER for numerics."""

    name = "sim"

    def __init__(self, flops_per_s=1e9):
        # accepts the registry parameter string: "sim:5e9" = 5 GFLOP/s
        self.flops_per_s = float(flops_per_s)
        if self.flops_per_s <= 0:
            raise ValueError("sim flops_per_s must be positive")

    def _flops(self, x, w) -> float:
        b, h, wd, _ = x.shape
        kh, kw, cin, cout = w.shape
        return 2.0 * b * h * wd * kh * kw * cin * cout

    def conv(self, x, w):
        time.sleep(self._flops(x, w) / self.flops_per_s)
        return np.zeros(x.shape[:-1] + (w.shape[-1],), np.float32)

    def conv_vjp(self, x, w, g):
        # backward is ~2x the forward cost (dX + dW)
        time.sleep(2.0 * self._flops(x, w) / self.flops_per_s)
        return np.zeros(x.shape, np.float32), np.zeros(w.shape, np.float32)


# ---------------------------------------------------------------------------
# probing — §4.1.1, generalized so each device times its OWN backend.
# ---------------------------------------------------------------------------


def probe_conv_time(
    backend,
    *,
    image_size: int,
    in_channels: int,
    kernel_size: int,
    num_kernels: int,
    batch: int,
    repeats: int = 3,
    slowdown: float = 1.0,
    seed: int = 0,
    device=None,
) -> float:
    """The paper's probe: median wall-clock of the reference convolution
    on the given backend (name or instance), scaled by the emulated
    slowdown — in BOTH directions: ``slowdown < 1.0`` emulates a FASTER
    device and must scale too, or its Eq. 1 share would be computed from
    the unscaled host time.  (HeteroCluster rejects sub-1 slowdowns —
    its op-level emulation can only sleep — but standalone Eq. 1 inputs
    for genuinely faster remote devices need the scaling, as do
    parameterized sim backends.)  Probing the backend a device actually
    runs keeps the Eq. 1 ratios exact for mixed-backend clusters.

    ``device`` (a torch device) times the backend on tensors there, as
    the master's shard of the card path runs: the operands move once,
    before the warm-up and under no span, and each call ends on the
    drain of its result, so the host's clock reads the device's time.
    None: numpy operands, copies included where the backend makes
    them."""
    if slowdown <= 0:
        raise ValueError(f"slowdown must be positive, got {slowdown}")
    if isinstance(backend, str):
        backend = get_backend(backend)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, image_size, image_size, in_channels)).astype(np.float32)
    w = rng.normal(
        size=(kernel_size, kernel_size, in_channels, num_kernels)
    ).astype(np.float32)
    if device is not None:
        x, w = seam(device, x=x, w=w)

    def call():
        y = backend.conv(x, w)
        if device is not None:
            drain(y)

    call()  # warm caches / jit
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    measured = float(np.median(times))
    return measured * slowdown
