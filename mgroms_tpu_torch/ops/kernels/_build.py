"""Build and load the hand-written CUDA kernels (``csrc/*.cu``), and the
checks their wrappers share.

``nvcc`` compiles every source into an object, all at once, then links
them into one shared library with a plain C interface, at first use, into
``build/mgroms_tpu_torch/`` at the root of the checkout; the file name
carries a hash of every source (headers included) and of the flags, so an
edited source is rebuilt.  The library is loaded with ``ctypes``.  Nothing
here runs at import: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mgroms_tpu_torch"

# -fmad=false: products and sums round separately, like the plain torch
# versions, so the kernels agree with them to 0 ulp (no --use_fast_math:
# divisions stay IEEE, as in the plain versions)
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas",
                 "-v"]
LINK_FLAGS = ["-shared"]


class BuildInfo:
    """What the one build of this process did (for chip_smoke.py)."""

    seconds: float = 0.0     # nvcc wall time (0 when the .so was cached)
    log: str = ""            # nvcc's output (-Xptxas -v: registers, spills)
    path: str = ""


_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"mg_colour_update_{dt}")
        # ColourArgs* | nz H W real tg0 ntargets emit bands | stream
        # (bf16: float32 state, bfloat16 operator, emit 0)
        fn.argtypes = [p] + [i] * 8 + [p]
        fn.restype = i
    for dt in ("f32", "f64", "bf16", "f64_bf16"):
        fn = getattr(lib, f"mg_sweep_fused_{dt}")
        # SweepArgs* | nz H W real ahead | stream
        fn.argtypes = [p] + [i] * 5 + [p]
        fn.restype = i
    # instance nz H W ahead | out[5]: K4's launch plan
    lib.mg_sweep_fused_plan.argtypes = [i] * 5 + [p]
    lib.mg_sweep_fused_plan.restype = i
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"mg_rr_{dt}")
        # RRArgs* | nz H W real mask mode bands | stream
        fn.argtypes = [p] + [i] * 7 + [p]
        fn.restype = i
        fn = getattr(lib, f"mg_relax_fused_{dt}")
        # p b cA out scratch | nz ny nx real nsweeps kind form | info
        # stream
        fn.argtypes = [p] * 5 + [i] * 7 + [p, p]
        fn.restype = i
        fn = getattr(lib, f"mg_residual_{dt}")
        # pe b cA r | nz ny nx real | stream
        fn.argtypes = [p] * 4 + [i] * 4 + [p]
        fn.restype = i
        fn = getattr(lib, f"mg_residual_overlap_x_{dt}")
        # p pw pe b cA r | nz ny nx nxw nxe real | stream
        fn.argtypes = [p] * 6 + [i] * 6 + [p]
        fn.restype = i
        fn = getattr(lib, f"mg_pack_streams_{dt}")
        # PackArgs* | nslabs C nz Hp Wp tj rows Wc wpad ntiles | stream
        fn.argtypes = [p] + [i] * 10 + [p]
        fn.restype = i
    for dt in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"mg_sweep_packed_{dt}")
        # SweepPackedArgs* | nz ntiles tj Wc window smem real first_chunk
        # last_chunk | stream
        fn.argtypes = [p] + [i] * 9 + [p]
        fn.restype = i
    # instance nz tj Wc window smem | out[3]: K8's launch plan
    lib.mg_sweep_packed_plan.argtypes = [i] * 6 + [p]
    lib.mg_sweep_packed_plan.restype = i
    # e0 e1 e2 blocks rb ud bet gam bq out | nz H W which | terms stream
    for fn in (lib.mg_dma_only, lib.mg_dma_only_bf16):
        fn.argtypes = [p] * 10 + [i] * 4 + [p, p]
        fn.restype = i
    # target | out[16][8]: K4's compiled term recipe
    lib.mg_sweep_terms.argtypes = [i, p]
    lib.mg_sweep_terms.restype = i
    # stream pointers[nstreams] ProbeGeom* out | nsteps nzb | stream
    lib.mg_probe_staged.argtypes = [p, p, p, i, i, p]
    lib.mg_probe_staged.restype = i
    # x out | nz H tj ng gw rc | stream
    lib.mg_probe_wide.argtypes = [p, p] + [i] * 6 + [p]
    lib.mg_probe_wide.restype = i
    # elem ny nx | out[6]: K7's launch plan
    lib.mg_residual_overlap_x_plan.argtypes = [i, i, i, p]
    lib.mg_residual_overlap_x_plan.restype = i
    lib.mg_enable_peer.argtypes = [i]
    lib.mg_enable_peer.restype = i
    # s0 s1 bq0 bq1 ud0 ud1 bet0 bet1 band out0 out1 | nz H W tg0 bf16 |
    # stream
    lib.mg_dma_only_bands.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.mg_dma_only_bands.restype = i
    # elem nz ny nx kind: the one-block form's record scratch bytes
    lib.mg_relax_fused_record_bytes.argtypes = [i] * 5
    lib.mg_relax_fused_record_bytes.restype = ctypes.c_longlong
    # x out | nz ny nx nsteps cluster | blocks stream
    lib.mg_step_floor.argtypes = [p, p] + [i] * 5 + [p, p]
    lib.mg_step_floor.restype = i
    # x out | n ntiles | stream
    lib.mg_fma_run.argtypes = [p, p, i, i, p]
    lib.mg_fma_run.restype = i
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"mg_rhs_fused_{dt}")
        # RhsArgs* | nz ny nx | stream
        fn.argtypes = [p] + [i] * 3 + [p]
        fn.restype = i
    u, z = ctypes.c_ulonglong, ctypes.c_size_t
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"mg_loop_condition_{dt}")
        # rsq bnorm it hist lim | cpc init | cont runs stream
        fn.argtypes = [p] * 5 + [i, i] + [p] * 3
        fn.restype = i
    # f64 | rsq bnorm it hist lim | cpc | cont runs | handle stream
    lib.mg_loop_condition_node.argtypes = ([i] + [p] * 5 + [i] + [p] * 2
                                           + [u, p])
    lib.mg_loop_condition_node.restype = i
    # f64 | rsq bnorm it hist lim | cpc | cont runs | graph_out body_out
    # handle_out
    lib.mg_loop_graph_open.argtypes = [i] + [p] * 5 + [i] + [p] * 5
    lib.mg_loop_graph_open.restype = i
    # body step f64 | rsq bnorm it hist lim | cpc | cont runs | handle
    # seconds
    lib.mg_loop_body_clone.argtypes = ([p, p, i] + [p] * 5 + [i] + [p] * 2
                                       + [u, p])
    lib.mg_loop_body_clone.restype = i
    lib.mg_capture_begin.argtypes = [p, p]
    lib.mg_capture_begin.restype = i
    lib.mg_capture_end.argtypes = [p]
    lib.mg_capture_end.restype = i
    # graph | exec_out seconds
    lib.mg_graph_instantiate.argtypes = [p, p, p]
    lib.mg_graph_instantiate.restype = i
    # graph | out cap len
    lib.mg_graph_kernels.argtypes = [p, p, z, p]
    lib.mg_graph_kernels.restype = i
    lib.mg_graph_launch.argtypes = [p, p]
    lib.mg_graph_launch.restype = i
    lib.mg_graph_destroy.argtypes = [p, p]
    lib.mg_graph_destroy.restype = i
    return lib


def _compile(sources, tmpdir: str) -> list:
    """One nvcc per source, all started together; the objects' paths."""
    procs = []
    for src in sources:
        obj = os.path.join(tmpdir, src.stem + ".o")
        procs.append((obj, subprocess.Popen(
            [_nvcc(), *COMPILE_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], False
    for (obj, proc), src in zip(procs, sources):
        out, _ = proc.communicate()
        BuildInfo.log += f"[{src.name}]\n{out}"
        failed |= proc.returncode != 0
        objs.append(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{BuildInfo.log}")
    return objs


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this process."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for f in sorted(f for f in CSRC.iterdir() if f.is_file()):
        h.update(f.name.encode() + f.read_bytes())
    so = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        BuildInfo.log = ""
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = _compile(sources, tmp)
            out = os.path.join(tmp, "kernels.so")
            proc = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", out, *objs],
                                  capture_output=True, text=True)
            BuildInfo.log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):"
                                   f"\n{BuildInfo.log}")
            # atomic: a concurrent build never sees a torn file
            os.replace(out, so)
        BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = str(so)
    _lib = _declare(ctypes.CDLL(str(so)))
    return _lib


# ------------------------------------------------- checks of the wrappers

def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version); False
    for a CUDA tensor (it launches its kernel); raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def check_tensors(named: dict, shapes: dict, dtype, device,
                  dtypes=None) -> None:
    """Every tensor of ``named`` is contiguous, on ``device``, of the
    shape ``shapes`` gives it and of ``dtype`` — or of ``dtypes[name]``
    where given (the operator blocks: the state type, or bfloat16 beside
    float32 state)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32/float64, got {dtype}")
    dtypes = dtypes or {}
    for name, want in dtypes.items():
        if want != dtype and (want, dtype) != (torch.bfloat16,
                                               torch.float32):
            raise ValueError(f"{name}: {want} blocks with {dtype} state")
    for name, t in named.items():
        want = dtypes.get(name, dtype)
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.device != device or t.dtype != want:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{want} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")


def instance(table: dict, state, operator, kernel: str):
    """``table[(state, operator)]``: what a kernel's wrapper launches for
    state values of dtype ``state`` and operator values of dtype
    ``operator`` (its instance's C entry); ``ValueError`` for a pair with
    no instance, before anything launches."""
    if (state, operator) not in table:
        raise ValueError(f"{kernel} has no instance for {state} state with "
                         f"{operator} operator values")
    return table[(state, operator)]


def ptr(t):
    return None if t is None else t.data_ptr()


def check_launch(rc: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a kernel entry."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
