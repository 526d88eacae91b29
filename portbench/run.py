"""The benchmark's command: one run of one cell, from the root of a
checkout.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints a few lines of its own on standard error, the numbers the check
compared beside their limits last, and as the last line of standard
output one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``,
the compared numbers).  It exits with a code other than 0, and prints no
result, where the card is missing, the program cannot be imported, or a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json      # noqa: E402
import sys       # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode cache, at a fixed path inside the checkout: where the
# environment turns bytecode writing off (PYTHONDONTWRITEBYTECODE) and the
# installed packages ship no bytecode, every run would compile torch's
# sources again, some 7 s of set-up; with the cache only a checkout's first
# run does.  Set before anything imports torch.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build"
                         / "pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    except harness.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: the run loaded {bad}, which the benchmark "
              "forbids", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}; the numbers compared:",
          file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "within" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} {verdict} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
