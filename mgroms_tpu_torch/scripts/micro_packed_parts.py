"""The packed-stream sweep taken apart, timed on the card.  Port of
``scripts/micro_packed_parts.py``:

  rhs_pack_ms      the RHS streams (K9 twice), once per relax call
  state_pack_ms    the state stream of one sweep (extend_quads + K9)
  kernel_only_ms   K8 on every chunk of pre-built packed streams
  out_concat_ms    the concatenation of the chunks' quads (C > 1 only)

    python -m mgroms_tpu_torch.scripts.micro_packed_parts [--nz 64
        --ny 1024 --nx 1024 --tj 8 --nchunks 1]

:func:`check` runs on any device; :func:`timed` needs a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import relax_compact as rc
from ..ops.kernels import sweep_packed as sp
from ._timing import card, card_line, emit, median_ms
from .micro_sweep_fused import setup


def _parts(dev, nz, ny, nx, tj, nchunks):
    cA, pack, q, bq = setup(dev, nz, ny, nx)
    sop = sp.build_sweep_operator(cA, pack, nz, ny // 2, nx // 2, tj=tj,
                                  nchunks=nchunks)
    del cA
    return pack, sop, q, bq


def check(dev, nz=3, ny=8, nx=16, tj=2, nchunks=2) -> float:
    """The parts (RHS pack, state pack, K8 per chunk, concatenation) put
    together against relax_packed_sweep: max |difference| (0: the same
    operations)."""
    pack, sop, q, bq = _parts(torch.device(dev), nz, ny, nx, tj, nchunks)
    pbq, pqs = sp.pack_rhs(bq, tj, nchunks)
    got = sp.sweep_packed_streams(sp.pack_state(q, tj, nchunks), pbq, pqs,
                                  sop, nz, True)
    want = sp.relax_packed_sweep(q, bq, pack, sop, 1)
    return max(float((got[t] - want[t]).abs().max()) for t in rc._TKEYS)


def timed(dev=None, nz=64, ny=1024, nx=1024, tj=sp.DEFAULT_TJ,
          nchunks=sp.DEFAULT_NCHUNKS, reps=20) -> dict:
    """Time the parts of one packed sweep on the card; the JSON rows."""
    dev = card(dev)
    print(card_line(), flush=True)
    rows = {}
    pack, sop, q, bq = _parts(dev, nz, ny, nx, tj, nchunks)
    emit(rows, "plan", {"tj": tj, "nchunks": nchunks})
    C = nchunks
    emit(rows, "rhs_pack_ms",
         median_ms(lambda: sp.pack_rhs(bq, tj, C), reps=reps))
    emit(rows, "state_pack_ms",
         median_ms(lambda: sp.pack_state(q, tj, C), reps=reps))
    pbq, pqs = sp.pack_rhs(bq, tj, C)
    psts = sp.pack_state(q, tj, C)

    def kernels():
        return [sp.sweep_chunk(psts[c], sop.pband[c], sop.ppiv[c],
                               sop.pseam[c], pbq[c], pqs[c], tj, nz, True,
                               c == 0, c == C - 1) for c in range(C)]

    emit(rows, "kernel_only_ms", median_ms(kernels, reps=reps))
    if C > 1:
        parts = kernels()
        emit(rows, "out_concat_ms", median_ms(
            lambda: [torch.cat([p[m] for p in parts], dim=2)
                     for m in range(4)], reps=reps))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--ny", type=int, default=1024)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--tj", type=int, default=sp.DEFAULT_TJ)
    ap.add_argument("--nchunks", type=int, default=sp.DEFAULT_NCHUNKS)
    args = ap.parse_args(argv)
    print(json.dumps(timed(None, args.nz, args.ny, args.nx, args.tj,
                           args.nchunks)))


if __name__ == "__main__":
    main()
