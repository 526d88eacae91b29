"""K7 (the x-seam residual) and K10's ``dma_only`` timed against builds of
other sources in the same call: another tree's kernels, or this tree's K7
with parts taken out.

    python -m mgroms_tpu_torch.scripts.micro_overlap [--earlier DIR]
        [--variants NAME ...]

``--earlier DIR``: the ``csrc`` directory of another tree (an earlier
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists); its ``rdma_halo.cu`` and ``roofline.cu`` are built alone, with the
package's flags and that directory's headers, into
``build/mgroms_tpu_torch/variants/``, one nvcc each, all started together,
and loaded beside the package's library.  ``--variants``: ``rdma_halo.cu`` or
``roofline.cu`` with named edits (:data:`VARIANTS`: K7's parts taken out,
which compute wrong values on purpose, other tiles and ring depths; K10's
ring depth and its blocks kernel without the first port's other paths),
only timed.

Cases: K7 on the four (64, 1024, 256) float32 tiles of CUC level 0 on a
virtual (1, 4) mesh of one card ('real'), and K10's ``dma_only`` at the CUC
level-0 quad shape (64, 512, 512) in its forms (float32 blocks: windows,
all, blocks; bfloat16 blocks: all, blocks).  Each library timed in turns
(CUDA events, median of 20), forward then reverse order; the package's
build and the other tree's are held to the plain versions bit for bit
first.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build
from ..ops.kernels import rdma_halo as k7
from ..ops.kernels import roofline as rl
from ..parallel import mesh as pmesh
from . import micro_roofline as mr
from ._timing import card, card_line, median_ms

# name -> (source, [(old, new) edits]): K7's and K10's parts taken out
# (these compute wrong values), K7's other tiles and ring depths, K10's
# window ring depth and its blocks kernel
VARIANTS = {
    # the band windows are not staged (the stencil reads stale values)
    "no_band_copies": ("rdma_halo.cu", [(
        """                cp_async<sizeof(T)>(
                    s + (uint32_t)((S::state + S::rhs + tid + m * kNT)
                                   * sizeof(T)),
                    ck + goff[m]);""",
        "                (void)ck;")]),
    # p, b and the halo columns (the seams among them) are not staged
    "no_state_copies": ("rdma_halo.cu", [(
        "            if (rsrc[m] == nullptr) continue;",
        "            continue;")]),
    # only the halo columns are not staged
    "no_seam": ("rdma_halo.cu", [(
        "            if (w >= rows + 2) rsrc[m] = nullptr;",
        "            rsrc[m] = nullptr;")]),
    # the ring runs, nothing is computed or stored
    "no_compute": ("rdma_halo.cu", [(
        "        if (!act) continue;\n        // state at",
        "        if (act || !act) continue;\n        // state at")]),
    # K7 on an 8 x 32 tile with a ring of 8 planes (2 blocks an SM)
    "tile8x32_ring8": ("rdma_halo.cu", [
        ("constexpr int kTI = 32, kTJ = 16;",
         "constexpr int kTI = 32, kTJ = 8;"),
        ("constexpr int kSlots = 4;", "constexpr int kSlots = 8;")]),
    # other block tiles of K7 (rows x columns; a thread a point)
    **{f"tile{tj}x{ti}": ("rdma_halo.cu", [(
        "constexpr int kTI = 32, kTJ = 16;",
        f"constexpr int kTI = {ti}, kTJ = {tj};")])
       for tj, ti in ((8, 32), (32, 32))},
    # K10's window ring 4 or 6 planes deep
    **{f"wring{n}": ("roofline.cu", [(
        "constexpr int kWSlots = 8;", f"constexpr int kWSlots = {n};")])
       for n in (4, 6)},
    # K10's window ring without the window copies (the terms read stale
    # shared memory; the RHS still rides in the ring)
    "windows_not_staged": ("roofline.cu", [(
        "                cp_async4(s + m * kWT * 4, wsrc[m] + (size_t)k * EP);",
        "                (void)s;")]),
    # K10's blocks-form kernel without the first port's windows and all
    # paths (compiled away)
    "blocks_only": ("roofline.cu", [(
        "const bool windows = which != 2, blks = which != 1, all = which"
        " == 0;",
        "const bool windows = false, blks = true, all = false;")]),
}
K7_ENTRIES = ("mg_residual_overlap_x_f32", "mg_residual_overlap_x_f64")
K10_ENTRIES = ("mg_dma_only", "mg_dma_only_bf16")


def _declare(lib, names):
    p, i = ctypes.c_void_p, ctypes.c_int
    for n in names:
        fn = getattr(lib, n)
        if n.startswith("mg_residual_overlap_x"):
            # p pw pe b cA r | nz ny nx nxw nxe real | stream
            fn.argtypes = [p] * 6 + [i] * 6 + [p]
        else:
            # e0 e1 e2 blocks rb ud bet gam bq out | nz H W which | terms
            # stream
            fn.argtypes = [p] * 10 + [i] * 4 + [p, p]
        fn.restype = i
    return lib


def build(sources: dict) -> dict:
    """``{name: (csrc dir, file, edits)}`` -> ``{name: ctypes library}``,
    each built alone with the package's flags and its directory's
    headers."""
    root = _build.BUILD_DIR / "variants"
    procs = {}
    for name, (csrc, fname, edits) in sources.items():
        text = (Path(csrc) / fname).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {fname} no longer holds "
                                   f"{old.strip()!r}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
             "-I", str(Path(csrc).resolve()), "-o", str(d / "lib.so"),
             str(d / fname)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(os.fspath(root / name / "lib.so"))
    return libs


def k7_case(dev):
    """The four tiles' launches and their plain version, per real."""
    nz, ny, nx, npx = 64, 1024, 1024, 4
    g = torch.Generator(device=dev).manual_seed(132)
    u = lambda *s: torch.rand(s, generator=g, device=dev)
    cA = 0.2 * u(8, nz, ny + 2, nx + 2) - 0.1
    cA[0] -= 4.0
    p, b = 2 * u(nz, ny, nx) - 1, 2 * u(nz, ny, nx) - 1
    mesh = pmesh.make_mesh(npx, 1, [dev] * npx)
    cut = lambda a, extra=(0, 0): pmesh.split_tiles(a, (1, npx),
                                                    mesh.devices, extra)
    pt, bt, ct = cut(p), cut(b), cut(cA, (2, 2))
    row = pt.grid[0]

    def kern():
        return [k7.residual_overlap_tile(
            row[i], bt.grid[0][i], ct.grid[0][i], True,
            row[i - 1] if i else None, row[i + 1] if i < npx - 1 else None)
            for i in range(npx)]

    want = k7.residual_overlap_x_plain
    plain = lambda: list(pmesh.shard_map(
        lambda p_l, b_l, c_l: want(p_l, b_l, c_l, True), mesh)(
            pt, bt, ct).flat())
    return kern, plain


def k10_cases(dev):
    """name -> (kernel call, plain call) of each dma_only form."""
    nz, H, W = 64, 512, 512
    o = mr.operands(dev, nz, H, W)
    b16 = (o["blocks"].to(torch.bfloat16), o["rb"].to(torch.bfloat16))
    cases = {}
    for which, blocks, rb in [(w, o["blocks"], o["rb"]) for w in rl.WHICH] \
            + [(w, *b16) for w in ("all", "blocks")]:
        a = (o["e3"], o["bq"], blocks, o["ud"], o["bet"], None, which, rb)
        name = f"dma_only {which}" + (" bf16" if blocks.dtype
                                      == torch.bfloat16 else "")
        cases[name] = (lambda a=a: rl.dma_only(*a),
                       lambda a=a: rl.dma_only_plain(*a))
    return cases


def _equal(got, want) -> bool:
    if isinstance(got, list):
        return all(torch.equal(x, y) for x, y in zip(got, want))
    return torch.equal(got, want)


def timed(dev=None, earlier=None, variants=()) -> dict:
    """``{case: {library: [ms forward, ms reverse]}}``; raises if the
    package's build (or the other tree's) is not bit for bit its plain
    version."""
    dev = card(dev)
    print(card_line(), flush=True)
    load = _build.load
    built = load()
    srcs = {v: (_build.CSRC, *VARIANTS[v]) for v in variants}
    if earlier:
        srcs["earlier_k7"] = (earlier, "rdma_halo.cu", [])
        srcs["earlier_k10"] = (earlier, "roofline.cu", [])
    libs = build(srcs)
    of = lambda fname, entries: {
        v: _declare(libs[v], entries) for v in variants
        if srcs[v][1] == fname}
    k7_libs = {"built": built, **of("rdma_halo.cu", K7_ENTRIES)}
    k10_libs = {"built": built, **of("roofline.cu", K10_ENTRIES)}
    if earlier:
        k7_libs["earlier"] = _declare(libs["earlier_k7"], K7_ENTRIES)
        k10_libs["earlier"] = _declare(libs["earlier_k10"], K10_ENTRIES)
    print("K7 plan at (1024, 256) f32:",
          json.dumps(k7.launch_plan(1024, 256)), flush=True)
    d = k7.design_bytes(64, 1024, 256)
    print(f"K7 design bytes, four tiles: {4 * sum(d.values()) / 1e9:.4f} GB "
          + json.dumps({k: 4 * v for k, v in d.items()}), flush=True)
    rows = {}
    cases = [("K7 4 x (64, 1024, 256)", *k7_case(dev), k7_libs)] + [
        (name, kern, plain, k10_libs)
        for name, (kern, plain) in k10_cases(dev).items()]
    try:
        for name, kern, plain, tlibs in cases:
            want = plain()
            for lname, lib in tlibs.items():
                if lname in ("built", "earlier"):
                    _build.load = lambda lib=lib: lib
                    ok = _equal(kern(), want)
                    _build.load = load
                    if not ok:
                        raise AssertionError(f"{name}: {lname} differs from "
                                             "the plain version")
            times = {lname: [] for lname in tlibs}
            order = list(tlibs)
            for turn in (order, order[::-1]):
                for lname in turn:
                    _build.load = lambda lib=tlibs[lname]: lib
                    times[lname].append(median_ms(kern))
                    _build.load = load
            rows[name] = times
            print(json.dumps({name: times}), flush=True)
            del want
            torch.cuda.empty_cache()
    finally:
        _build.load = load
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="csrc directory of another tree")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS))
    a = ap.parse_args(argv)
    timed(earlier=a.earlier, variants=a.variants)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
