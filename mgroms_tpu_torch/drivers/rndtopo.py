"""Random-topography benchmark driver (reference ``testrndtopo``,
src/mg_testrndtopo.f90 — diff-identical to the seamount driver apart from
the bathymetry; cases/rndtopo.py draws it from ``--seed``):

    python -m mgroms_tpu_torch.drivers.rndtopo [--nx 64 ...] [--seed 0]
"""

from .common import base_parser, run_case
from ..cases.rndtopo import setup_rndtopo


def main(argv=None):
    p = base_parser()
    p.add_argument("--Htot", type=float, default=4.0e3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print("Initialise rndtopo bench")
    case = setup_rndtopo(args.nx, args.ny, args.nz, Htot=args.Htot,
                         seed=args.seed)
    return run_case(args, case)


if __name__ == "__main__":
    main()
