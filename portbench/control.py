"""The readings the check's limits are set from, on the card at a cell's own
size: for each seed, the program's numbers and the control's on the same
steps, in one process (the set-up is paid once).

    python3 -m portbench.control --workload <cell> --seconds 3 --seeds 1 2 3 ...

For each seed it makes the pool, runs a short window at the cell's own
load (the same closed loop and step sampling as a run), and reads on each
sampled step:

- ``program``: the check's numbers of what the step gave back;
- ``control``: the same numbers of the control (check.control_outputs:
  the step's pressure in bfloat16, the projection in bfloat16);
- ``one_point``: the step's pressure altered at one point drawn from the
  seed by its largest magnitude, the velocities left as the step gave them;
- ``one_fcycle``: the step's inputs solved again with one F-cycle at most
  (``maxiter=1``), a solve stopped short of the tolerance;
- ``program_own_res``: the largest relative residual the program reported
  for its own solves in the window (``SolveInfo.res``, in its precision).

``failed`` is, for the program, the window's steps whose own residual
was over the tolerance; for ``one_fcycle``, the sampled steps whose stopped
solve reported one; the control and ``one_point`` report none (0).

It prints one JSON line a seed (the worst over the sampled steps, and for
each kind whether the limits pass it) and the
F-cycles each field needed, and writes the lines to ``--out`` as well.
The benchmark's runs never run this.
"""

import argparse
import json
import random
import sys
import time

import torch

from . import check, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    c = harness.load_cell(args.workload)
    lim = check.limits(args.workload)
    s = harness.Cell(c, dev)
    ref = check.Reference(s.case, s.nz, dev)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        s.load_pool(seed)
        s.warm(False)
        win = s.window(args.seconds, False, seed)
        prog, ctrl, one, short = [], [], [], []
        short_failed = 0
        rng = random.Random(seed)
        for i, out in win.samples:
            inputs = s.pool[i]
            prog.append(check.readings(ref, inputs, out))
            ctrl.append(check.readings(
                ref, inputs, check.control_outputs(s.case, s.nz, inputs,
                                                   out)))
            p = out[3].clone()
            k, j, ii = (rng.randrange(d) for d in p.shape)
            p[k, j, ii] += p.abs().max()
            one.append(check.readings(ref, inputs, (*out[:3], p)))
            del p
            u, v, w, p, info = s.model.solve(*inputs, tol=s.tol, maxiter=1)
            short_failed += not (info.res <= s.tol)
            short.append(check.readings(ref, inputs, (u, v, w, p)))
            del u, v, w, p
        line_kinds = {
            "program": check.worst(prog) | {"failed": win.failed},
            "control": check.worst(ctrl) | {"failed": 0},
            "one_point": check.worst(one) | {"failed": 0},
            "one_fcycle": check.worst(short) | {"failed": short_failed}}
        line = {"workload": args.workload, "seed": seed, "steps": win.n,
                "device": torch.cuda.get_device_name(dev),
                "fields_fcycles": harness.fields_fcycles(win, len(s.pool)),
                **line_kinds,
                "program_own_res": max(win.own_res),
                "correct": {k: check.judge(line_kinds[k], lim)[0]
                            for k in line_kinds},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del win
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
