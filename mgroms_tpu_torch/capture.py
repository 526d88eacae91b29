"""The convergence step as a CUDA graph: the port's counterpart of
``jax.jit(solve_step)`` (``mgroms_tpu/solver.py:695``) and of the JAX
package's on-device loop (``_solve_device_loop``, ``:706-748``).

PyTorch runs eagerly, so an F-cycle enqueues its ~40k device operations one
by one from Python and the host, not the card, sets its pace.  A
:class:`CapturedStep` records one convergence step (``cycles_per_check``
F-cycles, the fresh residual and its norm: ``solver.solve_step``) of a
single-device backend on the card once, with ``torch.cuda.graph``, and
the solve replays it: the same kernels on the same buffers, one launch a
step.

- **Static buffers.**  The step reads the level-0 state ``p``, ``b`` and
  ``r`` (a ``QuadField``'s four quads on a quad level 0, else one array)
  from buffers of its own and copies its results back into them at the
  graph's end (4 state-sized copies: p and r read and written, 1 GiB of
  traffic a step at CUC 1024^2 x 64 in float32), beside ``rsq`` =
  ||r||^2 and ``rnorm`` = ||r||.  The solve loads its iterates into them
  (:meth:`CapturedStep.load`) and reads the pressure back
  (:meth:`CapturedStep.result`).
- **Warm-up.**  Before it captures, the step runs once eagerly, on a side
  stream, on the static buffers while they hold zeros (not yet the solve's
  iterates): the kernel library's build and load, the loading of each
  kernel's module, K6's cluster occupancy query (cached by the
  launcher) and the cuBLAS handle of ``coarsest='direct'``'s dense
  product happen there, not under capture (that product replays bit for
  bit in the captured step on an H100, torch 2.11, CUDA 12.8).  The launchers' remaining
  runtime calls at every launch (``cudaFuncSetAttribute``, K4's
  occupancy query) are allowed under capture in torch's default
  ``"global"`` mode, as are K4's cooperative and K6's cluster launches
  (found on an H100 with CUDA 12.8), so the step is captured in that
  mode.
- **Launch counts.**  What a graph launches is read from the graph: its
  kernel nodes, by function (:func:`graph_launches`, through
  ``ops.kernels.kernel_key``).  At capture they must equal what the
  wrappers counted as they enqueued the step, else the capture raises;
  each replay then adds the graph's counts to the ``LAUNCHES`` counters.
  The warm-up's launches (on zeros, before the solve) and the wrappers'
  counts during the capture (which launches nothing) are taken back out,
  so the counters hold the solve's launches, as in an eager solve.
- **Failure.**  A capture or instantiation that fails raises: no solve
  falls back to the eager loop.
- **Lifetime.**  A backend keeps its graphs (:func:`captured_step`), keyed
  by the solver configuration and the level-0 state layout, and
  ``NHModel.use_operators`` builds a new backend, so a graph never
  outlives the operators whose pointers it holds.

:class:`DeviceLoop` runs the whole convergence loop as one CUDA graph
(``csrc/device_loop.cu``): the loop condition kernel (prologue mode)
sets the condition of a WHILE node whose body is the captured step
(cloned as a child graph: its buffers stay in the step's pool) and the
condition kernel, which writes the history on the device and counts its
runs.  The host reads the counter, the runs and the history once per
solve; the body's launches are counted from its nodes times the runs.
Instantiating a WHILE body grows with the square of its node count on an
H100 (CUDA 12.8; PERF.md), a plain graph's linearly.

With spans on (``utils.tictoc.record_spans``) each build by
:func:`captured_step` or :func:`captured_loop` is a ``capture`` span on
the host clock alone, so that no event is recorded while a capture is
open; solver.py spans the loads, replays and launches.
"""

from __future__ import annotations

import collections
import ctypes
import time
import weakref
from typing import Optional

import torch

from .ops import kernels
from .ops.kernels._build import check_launch, ptr
from .ops.kernels import (_build, device_loop, relax_fused, relax_tiled,
                          stencil_tiled, sweep_fused)
from .ops.relax_compact import QuadField
from .utils.tictoc import span

# the kernel modules a convergence step launches (the condition's is not)
STEP_MODULES = (relax_tiled, stencil_tiled, relax_fused, sweep_fused)


def _snapshot(mods) -> list:
    return [dict(m.LAUNCHES) for m in mods]


def _restore(mods, counts: list) -> None:
    for m, c in zip(mods, counts):
        m.LAUNCHES.update(c)


def _delta(mods, before: list) -> collections.Counter:
    return collections.Counter(
        {k: n - b[k] for m, b in zip(mods, before)
         for k, n in m.LAUNCHES.items() if n != b[k]})


def graph_launches(graph: int):
    """(launches by ``LAUNCHES`` key, nodes) of one launch of the CUDA
    graph ``graph``: its kernel nodes (child graphs included) whose
    function a kernel module names, and the count of every node."""
    names = device_loop.graph_kernels(graph)
    out = collections.Counter()
    for name, n in names.items():
        key = kernels.kernel_key(name)
        if key is not None:
            out[key] += n
    return out, sum(names.values())


def _check_census(what: str, census, counted) -> None:
    if census != counted:
        raise RuntimeError(
            f"{what}: the graph's kernel nodes {dict(census)} differ from "
            f"the launches its wrappers enqueued {dict(counted)}")


def _copy(dst, src) -> None:
    if isinstance(dst, QuadField):
        for d, s in zip(dst.quads, src.quads):
            d.copy_(s)
    else:
        dst.copy_(src)


def layout(be) -> tuple:
    """The level-0 state layout a captured step is built for."""
    s = be.levels[0]
    cA = be.ops[0].cA
    return (be.state_quads(0), (s.nzg, s.nyg, s.nxg), cA.dtype, cA.device)


def step_body(be, cfg, st):
    """The step on ``st``'s static buffers (a CapturedStep's), as a
    function of no arguments (kept by no graph: a backend's graphs hold no
    reference to the backend)."""
    from .solver import step_norm

    def body():
        p, r, rsq, rnorm = step_norm(be, st.p, st.b, st.r, cfg)
        _copy(st.p, p)
        _copy(st.r, r)
        st.rsq.copy_(rsq)
        st.rnorm.copy_(rnorm)

    return body


class CapturedStep:
    """One convergence step of backend ``be`` under ``cfg``, captured on
    static buffers (module docstring).  ``capture_s`` and
    ``instantiate_s`` are the one-off costs of the capture and of the
    graph's instantiation, ``warmup_s`` the eager warm-up's;
    ``launches`` the kernels one replay launches (from the graph's nodes),
    ``nodes`` its node count."""

    def __init__(self, be, cfg):
        quads, _, dtype, dev = layout(be)
        self.device = dev
        self.p = be.zeros(0, as_quads=quads)
        self.b = be.zeros(0, as_quads=quads)
        self.r = be.zeros(0, as_quads=quads)
        self.rsq = torch.zeros((), dtype=dtype, device=dev)
        self.rnorm = torch.zeros((), dtype=dtype, device=dev)
        body = step_body(be, cfg, self)
        before = _snapshot(STEP_MODULES)
        _build.load()
        try:
            t0 = time.perf_counter()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            warm = _snapshot(STEP_MODULES)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.device(dev):
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="global"):
                    body()
                t2 = time.perf_counter()
                self.graph.instantiate()
                torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            self.launches, self.nodes = graph_launches(
                self.graph.raw_cuda_graph())
            _check_census("captured step", self.launches,
                          _delta(STEP_MODULES, warm))
        finally:
            _restore(STEP_MODULES, before)
        self.warmup_s, self.capture_s, self.instantiate_s = (
            t1 - t0, t2 - t1, t3 - t2)

    def load(self, p, b, r, rsq: Optional[torch.Tensor] = None) -> None:
        """The solve's iterates into the static buffers."""
        _copy(self.p, p)
        _copy(self.b, b)
        _copy(self.r, r)
        if rsq is not None:
            self.rsq.copy_(rsq)

    def replay(self) -> torch.Tensor:
        """One step on the card; returns ``rnorm`` (not read here)."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels.add_launches(self.launches)
        return self.rnorm

    def result(self) -> torch.Tensor:
        """The pressure in full layout, a tensor of its own."""
        return (self.p.merge() if isinstance(self.p, QuadField)
                else self.p.clone())


def _destroy(lib, handles) -> None:
    lib.mg_graph_destroy(handles[0], handles[1])


class DeviceLoop:
    """The convergence loop of ``step`` under ``cfg`` as one CUDA graph
    (module docstring): ``capacity`` history slots (at least maxiter +
    cycles_per_check).  ``clone_s`` and ``instantiate_s`` are the one-off
    costs of cloning the step into the WHILE body and of instantiating
    the graph, ``body_launches`` and ``body_nodes`` one body run's kernels
    (from its nodes) and nodes."""

    def __init__(self, step: CapturedStep, cfg, capacity: int):
        self.step = step
        self.cpc = cpc = cfg.cycles_per_check
        dev = step.device
        self.bnorm = torch.zeros_like(step.rsq)
        self.buf = buf = device_loop.LoopBuffers(step.rsq, capacity)
        f64 = int(step.rsq.dtype == torch.float64)
        args = (ptr(step.rsq), ptr(self.bnorm), ptr(buf.it), ptr(buf.hist),
                ptr(buf.lim), cpc, ptr(buf.cont), ptr(buf.runs))
        lib = _build.load()
        g, body, handle = (ctypes.c_void_p(), ctypes.c_void_p(),
                           ctypes.c_ulonglong())
        with torch.cuda.device(dev):
            rc = lib.mg_loop_graph_open(f64, *args, ctypes.byref(g),
                                        ctypes.byref(body),
                                        ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(
                f"the device loop's CUDA graph (a WHILE node) could not be "
                f"built: CUDA error {rc}")
        self._handles = [g.value, None]
        weakref.finalize(self, _destroy, lib, self._handles)

        # the body: the captured step cloned as a child graph, then the
        # condition kernel
        secs = ctypes.c_double()
        with torch.cuda.device(dev):
            rc = lib.mg_loop_body_clone(body.value,
                                        step.graph.raw_cuda_graph(), f64,
                                        *args, handle.value,
                                        ctypes.byref(secs))
        if rc != 0:
            raise RuntimeError(f"the device loop's WHILE body could not be "
                               f"built: CUDA error {rc}")
        self.clone_s = secs.value
        self.body_launches, self.body_nodes = graph_launches(body.value)
        _check_census("device loop body", self.body_launches,
                      step.launches + collections.Counter(loop_condition=1))
        e = ctypes.c_void_p()
        with torch.cuda.device(dev):
            rc = lib.mg_graph_instantiate(g.value, ctypes.byref(e),
                                          ctypes.byref(secs))
        if rc != 0:
            raise RuntimeError(f"the device loop's CUDA graph could not be "
                               f"instantiated: CUDA error {rc}")
        self._handles[1] = e.value
        self.instantiate_s = secs.value

    @property
    def capacity(self) -> int:
        return self.buf.capacity

    def load(self, p, b, r, rsq, bnorm, maxiter: int, tol: float) -> None:
        """The prologue's iterates (p, b, r in level 0's state layout,
        ||r||^2 and ||b||) and the loop's limits into its buffers."""
        self.step.load(p, b, r, rsq)
        self.bnorm.copy_(bnorm)
        self.buf.reset(maxiter, tol, self.cpc)

    def launch(self) -> None:
        """The loop on the card, from what :meth:`load` put there; the
        pressure stays in ``step.p``."""
        lib = _build.load()
        with torch.cuda.device(self.step.device):
            rc = lib.mg_graph_launch(self._handles[1],
                                     torch.cuda.current_stream().cuda_stream)
        check_launch(rc, "device loop graph")

    def read(self):
        """(cycles run, history to them, NaN where no check landed) of the
        last :meth:`launch`: one device-to-host read.  The counters gain
        the prologue's condition once and the body's kernel nodes once a
        body run: the condition's runs, counted on the device, less the
        prologue's."""
        niter, hist, runs = self.buf.read()
        # the root's one kernel node is the prologue's condition
        kernels.add_launches({"loop_condition": 1})
        kernels.add_launches(self.body_launches, runs - 1)
        return niter, hist


def captured_step(be, cfg) -> CapturedStep:
    """``be``'s captured step under ``cfg``, captured at the first call."""
    key = ("step", cfg, layout(be))
    if key not in be.graphs:
        with span("capture"):
            be.graphs[key] = CapturedStep(be, cfg)
    return be.graphs[key]


def captured_loop(be, cfg, maxiter: int) -> DeviceLoop:
    """``be``'s device loop under ``cfg``, built at the first call with
    room for ``cfg.solver_maxiter`` cycles, or ``maxiter`` where more
    (again for a longer history)."""
    key = ("loop", cfg, layout(be))
    need = maxiter + cfg.cycles_per_check
    loop = be.graphs.get(key)
    if loop is None or loop.capacity < need:
        be.graphs.pop(key, None)
        step = captured_step(be, cfg)
        with span("capture"):
            loop = be.graphs[key] = DeviceLoop(
                step, cfg,
                max(need, cfg.solver_maxiter + cfg.cycles_per_check))
    return loop
