"""The device loop's condition: its hand-written CUDA kernel
(``csrc/device_loop.cu``), its plain torch version, and the buffers the
loop keeps on the device.

Port of the condition and the history update of the JAX package's
``_solve_device_loop`` (``mgroms_tpu/solver.py:731-742``: ``cond`` and the
end of ``body``, which XLA compiles inside ``lax.while_loop``).  One call
reads ``||r||^2`` and ``||b||``, forms the relative residual as
``solver.solve_p``'s host loop does (the square root in the state's type;
the division in float64, or in the state's type in the prologue's first
call, as ``solve_init``'s ``res0``), advances the cycle counter by
``cycles_per_check`` (0 in the first call), writes the history slot and
the decision ``i < maxiter and res > tol`` (False for a NaN residual),
and adds one to ``runs``, the count of its runs that the device keeps.
Inside the device loop's CUDA graph the kernel also sets the WHILE node's
condition (``capture.DeviceLoop``); the wrapper here launches it outside a
graph.  The wrapper runs the plain version for tensors on the CPU only;
for CUDA tensors it checks them, launches the kernel or raises.
``LAUNCHES`` counts the kernel's launches, those of the device loop's
graph included (``capture.DeviceLoop.read`` adds the runs the device
counted).

:func:`graph_kernels` lists a CUDA graph's kernel nodes by function name
(csrc/device_loop.cu's ``mg_graph_kernels``): capture.py counts a
replayed graph's launches from it.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from ._build import check_launch, on_cpu, ptr

LAUNCHES = {"loop_condition": 0}
# the kernel function behind the count (ops/kernels/__init__.py)
GRAPH_NAMES = ((r"\bloop_condition_kernel<", "loop_condition"),)


def reset_launches() -> None:
    LAUNCHES["loop_condition"] = 0


class LoopBuffers:
    """What the device loop keeps on the device beside the iterates: the
    cycle counter ``it``, the decision ``cont`` and the condition's run
    count ``runs`` (int32 scalars), the history (float64, ``capacity``
    slots, NaN where no check landed) and ``lim`` = (maxiter, tol) in
    float64."""

    def __init__(self, like: torch.Tensor, capacity: int):
        dev = like.device
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.cont = torch.zeros((), dtype=torch.int32, device=dev)
        self.runs = torch.zeros((), dtype=torch.int32, device=dev)
        self.hist = torch.full((capacity,), float("nan"),
                               dtype=torch.float64, device=dev)
        self.lim = torch.zeros(2, dtype=torch.float64, device=dev)

    @property
    def capacity(self) -> int:
        return self.hist.numel()

    def reset(self, maxiter: int, tol: float, cpc: int) -> None:
        """A new solve: a history of NaN, no run, the loop's limits."""
        if maxiter + cpc > self.capacity:
            raise ValueError(f"a history of {self.capacity} slots holds no "
                             f"{maxiter} cycles checked every {cpc}")
        self.hist.fill_(float("nan"))
        self.runs.zero_()
        self.lim.copy_(torch.tensor([float(maxiter), float(tol)],
                                    dtype=torch.float64))

    def read(self):
        """(cycles run, history trimmed to them, the condition's runs) in
        one device-to-host copy."""
        host = torch.cat([self.it.to(torch.float64).reshape(1),
                          self.runs.to(torch.float64).reshape(1),
                          self.hist]).cpu()
        niter = int(host[0])
        return niter, host[2:niter + 3].tolist(), int(host[1])


def loop_condition_plain(rsq, bnorm, it, hist, lim, cpc: int, init: bool,
                         cont, runs) -> None:
    """The kernel's recipe in torch, in place on ``it``, ``hist``,
    ``cont`` and ``runs`` (no host read: it runs on either device)."""
    s = torch.sqrt(rsq)
    if init:
        i = torch.zeros_like(it)
        res = (s / bnorm).to(torch.float64)
    else:
        i = it + cpc
        res = s.to(torch.float64) / bnorm.to(torch.float64)
    it.copy_(i)
    hist.index_copy_(0, i.to(torch.int64).reshape(1), res.reshape(1))
    runs.add_(1)
    go = (i < lim[0].to(torch.int32)) & (res > lim[1])
    cont.copy_(go.to(torch.int32))


def loop_condition(rsq, bnorm, it, hist, lim, cpc: int, init: bool,
                   cont, runs) -> None:
    """One check of the device loop (module docstring): ``rsq`` and
    ``bnorm`` scalars of the state's type, ``it``/``cont``/``runs`` int32
    scalars, ``hist`` float64 with at least maxiter + ``cpc`` slots,
    ``lim`` = (maxiter, tol) float64."""
    if on_cpu(rsq):
        return loop_condition_plain(rsq, bnorm, it, hist, lim, cpc, init,
                                    cont, runs)
    dtype, dev = rsq.dtype, rsq.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"loop_condition takes float32/float64, got {dtype}")
    want = {"rsq": (rsq, dtype, ()), "bnorm": (bnorm, dtype, ()),
            "it": (it, torch.int32, ()), "cont": (cont, torch.int32, ()),
            "runs": (runs, torch.int32, ()),
            "lim": (lim, torch.float64, (2,)),
            "hist": (hist, torch.float64, (hist.numel(),))}
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dt} {shape} on {dev}")
    if not hist.is_contiguous() or cpc < 1:
        raise ValueError("hist must be contiguous and cpc >= 1")
    lib = _build.load()
    fn = (lib.mg_loop_condition_f32 if dtype == torch.float32
          else lib.mg_loop_condition_f64)
    with torch.cuda.device(dev):
        rc = fn(ptr(rsq), ptr(bnorm), ptr(it), ptr(hist), ptr(lim), cpc,
                int(init), ptr(cont), ptr(runs),
                torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "loop_condition")
    LAUNCHES["loop_condition"] += 1


def graph_kernels(graph: int) -> collections.Counter:
    """The nodes of the CUDA graph ``graph`` (a ``cudaGraph_t``; child
    graphs walked, a conditional node's body not): a kernel node counted
    under its function's demangled name, any other node under ``"#node
    type N"`` (its ``cudaGraphNodeType``) or ``"#child graph"``."""
    lib = _build.load()
    cap = 1 << 20
    while True:
        out = ctypes.create_string_buffer(cap)
        n = ctypes.c_size_t()
        rc = lib.mg_graph_kernels(graph, out, cap, ctypes.byref(n))
        if rc != -1:
            break
        cap = n.value + 1
    if rc != 0:
        raise RuntimeError(f"mg_graph_kernels: error {rc} (stage x 1000 + "
                           f"the driver's CUresult, csrc/device_loop.cu)")
    counts = collections.Counter()
    for line in out.value.decode().splitlines():
        k, name = line.split("\t", 1)
        counts[name] += int(k)
    return counts
