"""The ranges a traced run records around calls into the program's
layers, from the benchmark's own files (the program has no spans yet).

``Spans.install`` wraps, for the length of the traced run only:

* ``CudaBackend.conv`` / ``conv_vjp`` in ``pb.cuda.conv`` /
  ``pb.cuda.conv_vjp``, and notes each call's argument shapes: the
  kernel rooflines read the work from these shapes and the time from
  the kernels launched inside the range;
* ``NumpyBackend.conv`` / ``conv_vjp`` in ``pb.cpu_shard`` (the CPU
  device's shard, on its own thread);
* the cluster's scatter halves in ``pb.scatter`` and its gathers in
  ``pb.gather`` (the master's own shard runs inside the gather);
* a serving chain's ``push`` / ``flush`` in ``pb.serve.push``.

The drivers add ``pb.step`` around each training step and ``pb.window``
around the measured window.
"""
from __future__ import annotations

import contextlib
import functools
import threading


class Spans:
    def __init__(self):
        self._undo = []
        self._lock = threading.Lock()
        self.calls = []  # (kind, x_shape, w_shape) of every cuda backend call

    @staticmethod
    def range(name: str):
        from torch.profiler import record_function

        return record_function(name)

    def _wrap(self, owner, attr: str, name: str, note: str | None = None):
        orig = getattr(owner, attr)
        is_class = isinstance(owner, type)

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if note is not None:
                x, w = (args[1], args[2]) if is_class else (args[0], args[1])
                with self._lock:
                    self.calls.append((note, tuple(x.shape), tuple(w.shape)))
            with self.range(name):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        if is_class:
            self._undo.append(lambda: setattr(owner, attr, orig))
        else:  # an instance attribute shadowing the class's method
            self._undo.append(lambda: owner.__dict__.pop(attr, None))

    def install(self, cluster=None, chain=None) -> "Spans":
        from repro_torch.core.backends import CudaBackend, NumpyBackend

        self._wrap(CudaBackend, "conv", "pb.cuda.conv", note="conv")
        self._wrap(CudaBackend, "conv_vjp", "pb.cuda.conv_vjp", note="conv_vjp")
        self._wrap(NumpyBackend, "conv", "pb.cpu_shard")
        self._wrap(NumpyBackend, "conv_vjp", "pb.cpu_shard")
        if cluster is not None:
            for attr in ("_scatter_conv_planned", "_scatter_bwd_planned"):
                self._wrap(cluster, attr, "pb.scatter")
            for attr in ("gather_conv", "gather_bwd"):
                self._wrap(cluster, attr, "pb.gather")
        if chain is not None:
            for attr in ("push", "flush"):
                self._wrap(chain, attr, "pb.serve.push")
        return self

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()


def no_range(name: str):
    """The untraced run's stand-in for ``Spans.range``."""
    return contextlib.nullcontext()
