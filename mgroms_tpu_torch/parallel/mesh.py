"""Device mesh, per-level distribution plan, tile grids and the lock-step
runner that takes the place of ``jax.shard_map``.

Port of ``mgroms_tpu/parallel/mesh.py`` (reference process topology,
mg_grids.f90:580-661: a Cartesian npx x npy grid, ``rank = pj*npx + pi``).
One process drives every device of the mesh, as ``shard_map``'s single
controller does:

- a :class:`Mesh` is an (npy, npx) grid of ``torch.device``s; a device may
  repeat (``["cuda:0"] * 4`` is a virtual 2x2 mesh on one card,
  ``["cpu"] * 8`` what the CPU tests use);
- a sharded level's state is a :class:`Tiles` grid of local tiles, each on
  its mesh device, blocked only along the level's active axes (staged
  agglomeration, levels.build_shard_plan); a replicated level is one
  tensor on the mesh's first device;
- :func:`shard_map` runs a per-tile program on every tile of a grid.  The
  programs run one at a time, in row-major tile order, and switch at each
  collective (:func:`ppermute`, :func:`psum`, :func:`all_tiles`): every
  tile deposits its operand, and each reads the round's operands when its
  turn comes back.  So the JAX package's per-shard code, halo exchanges
  inside it (parallel/exchange.py), runs here as written, and the kernels
  of all tiles go to the device in one fixed order;
- the GSPMD pieces: :meth:`MeshPlan.sharding` is a level's placement (its
  tile grid of devices, or the first device), :meth:`MeshPlan.constrain`
  moves a state into it (the tiles cut or joined where the layout
  changes), and :class:`Replicated` holds a value whole once on each
  distinct device of the mesh (the JAX package's ``P()`` operators).

:data:`COLLECTIVES` counts what the runner does by kind: ``shard_map``
calls, ``ppermute`` and ``psum`` rounds (``all_tiles`` among them), and
the ``join`` and ``split`` of whole grids.
"""

from __future__ import annotations

import collections
import dataclasses
import operator
import threading
from typing import List, NamedTuple, Optional, Sequence

import torch

from ..levels import LevelSpec, build_shard_plan
from ..ops.relax_compact import QuadField

# a program waiting this long for its turn means the tiles left lock step
_TURN_TIMEOUT_S = 600.0

# the runner's work by kind (module docstring); a round counts once, not
# once a tile
COLLECTIVES = collections.Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collectives() -> dict:
    """The counts since the last :func:`reset_collectives`."""
    return {k: COLLECTIVES[k] for k in
            ("shard_map", "ppermute", "psum", "join", "split")}


class Mesh:
    """An (npy, npx) grid of devices; x is the fast axis
    (``devices[pj][pi]`` holds rank ``pj*npx + pi``)."""

    def __init__(self, grid):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in grid)
        kinds = {d.type for row in self.devices for d in row}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh takes CPU or CUDA devices, one kind: "
                             f"{sorted(kinds)}")

    @property
    def shape(self):
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def first(self) -> torch.device:
        """Where replicated levels live."""
        return self.devices[0][0]

    @property
    def on_card(self) -> bool:
        return self.first.type == "cuda"

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in rank order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def tile_devices(self, axes):
        """Device grid of a level blocked along ``axes`` = (py or None,
        px or None): one tile per active-axis coordinate, the dropped axis
        taking coordinate 0."""
        npy, npx = self.shape
        ny = npy if axes[0] else 1
        nx = npx if axes[1] else 1
        return tuple(tuple(self.devices[j][i] for i in range(nx))
                     for j in range(ny))


def make_mesh(npx: int, npy: int, devices: Optional[Sequence] = None
              ) -> Mesh:
    """The (py, px) mesh on the first npx*npy of ``devices`` (default:
    every visible CUDA device, never the CPU); raises if there are fewer."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) < npx * npy:
        raise ValueError(f"need {npx * npy} devices, have {len(devices)}")
    return Mesh([devices[j * npx:(j + 1) * npx] for j in range(npy)])


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Per-level distribution schedule over a fixed mesh (sharded levels
    blocked along their active axes; below ``nsmall`` replicated — the
    replicate-not-idle agglomeration policy, mg_gather.f90)."""

    mesh: Mesh
    shards: tuple          # tuple[ShardSpec]

    @classmethod
    def create(cls, mesh: Mesh, levels: List[LevelSpec],
               nsmall: int = 8) -> "MeshPlan":
        npy, npx = mesh.shape
        return cls(mesh=mesh, shards=tuple(build_shard_plan(
            levels, npx=npx, npy=npy, nsmall=nsmall)))

    def spec(self, lev: int):
        """The level's active mesh axes ("py" or None, "px" or None) — the
        port's form of the JAX ``PartitionSpec``."""
        sh = self.shards[lev]
        return ("py" if sh.shard_py else None,
                "px" if sh.shard_px else None)

    def sharding(self, lev: int, ndim: int = 3) -> "Sharding":
        """Level ``lev``'s placement of an ``ndim``-dimensional state: its
        tiles along the active axes, or (replicated) the first device."""
        if not self.shards[lev].sharded:
            return Sharding((), ((self.mesh.first,),))
        return Sharding((None,) * (ndim - 2) + self.spec(lev),
                        self.mesh.tile_devices(self.spec(lev)))

    def constrain(self, lev: int, x):
        """``x`` — a global tensor, a QuadField of global quads, or a
        Tiles grid of either in another level's layout — in level
        ``lev``'s placement (:meth:`sharding`): a Tiles grid on a sharded
        level, one tensor (or QuadField) on the first device on a
        replicated one.  Tiles already in that grid pass unchanged; others
        are joined first (quads quad by quad)."""
        grid = self.sharding(lev).devices
        shape = (len(grid), len(grid[0]))
        sharded = self.shards[lev].sharded
        if isinstance(x, Tiles):
            if sharded and x.shape == shape:
                return x
            if x.is_quads:
                x = QuadField(join_tiles(x.map(lambda q, k=k: q.quads[k]),
                                         self.mesh.first)
                              for k in range(4))
            else:
                x = join_tiles(x, self.mesh.first)
        if not sharded:
            return move(x, self.mesh.first)
        if isinstance(x, QuadField):
            per_quad = [split_tiles(q, shape, grid) for q in x.quads]
            return Tiles([[QuadField(t.grid[j][i] for t in per_quad)
                           for i in range(shape[1])]
                          for j in range(shape[0])])
        return split_tiles(x, shape, grid)


class Sharding(NamedTuple):
    """A placement (:meth:`MeshPlan.sharding`): ``spec`` the mesh axis of
    each dimension (() when replicated, as ``P()``), ``devices`` the tile
    grid of devices."""
    spec: tuple
    devices: tuple


class Replicated:
    """A value (a tensor, or a tuple of them such as a LevelOperator) held
    whole once on each distinct device of a mesh — the port's form of a
    JAX array replicated over the mesh (``P()``).  ``first`` is the copy on
    the mesh's first device (the value itself where it already lies
    there); :meth:`on` the copy a tile on ``device`` reads.  A virtual
    mesh of one card holds one copy."""

    __slots__ = ("copies",)

    def __init__(self, value, mesh: "Mesh"):
        self.copies = {d: move(value, d) for d in mesh.distinct}

    @property
    def first(self):
        return next(iter(self.copies.values()))

    def on(self, device):
        return self.copies[torch.device(device)]


# ------------------------------------------------------------ tile grids

class Tiles:
    """A grid of per-tile values (tensors, QuadFields, packs ...), row j
    along py, column i along px."""

    __slots__ = ("grid",)

    def __init__(self, grid):
        self.grid = tuple(tuple(row) for row in grid)

    @property
    def shape(self):
        return len(self.grid), len(self.grid[0])

    def flat(self) -> list:
        return [x for row in self.grid for x in row]

    def map(self, fn, *others) -> "Tiles":
        """``fn`` on every tile (with the same tile of each of ``others``),
        in row-major order; for work that needs no collective."""
        return Tiles([[fn(x, *(o.grid[j][i] for o in others))
                       for i, x in enumerate(row)]
                      for j, row in enumerate(self.grid)])

    def __add__(self, other: "Tiles") -> "Tiles":
        return self.map(operator.add, other)

    @property
    def is_quads(self) -> bool:
        """Tiles of quad-parity state (each tile a QuadField)."""
        return hasattr(self.grid[0][0], "quads")


def move(obj, device):
    """``obj`` with every tensor in it (through tuples and NamedTuples) on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [move(x, device) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else tuple(items)
    return obj


def split_tiles(a: torch.Tensor, shape, devices, extra=(0, 0)) -> Tiles:
    """The (ny, nx) grid ``shape`` of tiles of ``a``'s last two dims, each
    with ``extra`` overlap rows/columns beyond its own (halo rings,
    staggered shared faces), contiguous on its device.  With ``extra``
    (0, 0) the tiles partition ``a``."""
    npy, npx = shape
    ej, ei = extra
    COLLECTIVES["split"] += 1
    ny_l = (a.shape[-2] - ej) // npy
    nx_l = (a.shape[-1] - ei) // npx
    return Tiles([[a[..., j * ny_l:(j + 1) * ny_l + ej,
                     i * nx_l:(i + 1) * nx_l + ei]
                   .to(devices[j][i]).contiguous()
                   for i in range(npx)] for j in range(npy)])


def join_tiles(t: Tiles, device) -> torch.Tensor:
    """Inverse of :func:`split_tiles` with ``extra`` (0, 0): the tiles of
    full-layout tensors joined on ``device``."""
    COLLECTIVES["join"] += 1
    return torch.cat([torch.cat([x.to(device) for x in row], dim=-1)
                      for row in t.grid], dim=-2)


# ------------------------------------------------------ lock-step runner

_ctx = threading.local()


class _Aborted(Exception):
    """Another tile's program failed; this one stops."""


class _Run:
    """One :func:`shard_map` call: ``n`` programs, one runnable at a time.
    ``turn`` is the index of the program that may run; a collective
    deposits an operand in the round's slot list and hands the turn on."""

    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.done = [False] * n
        self.error = None
        self.rounds = {}          # round -> [operand per tile]
        self.deposits = {}        # round -> tiles that deposited
        self.reads = {}           # round -> tiles that read it

    def wait_turn(self, k: int) -> None:
        with self.cv:
            while self.turn != k and self.error is None:
                if not self.cv.wait(timeout=_TURN_TIMEOUT_S):
                    self.fail(RuntimeError("shard_map: the tiles left lock "
                                           "step (a program never reached "
                                           "a collective)"))
            if self.error is not None:
                raise _Aborted()

    def hand_on(self, k: int) -> None:
        with self.cv:
            for s in range(1, self.n + 1):
                nxt = (k + s) % self.n
                if not self.done[nxt]:
                    self.turn = nxt
                    break
            self.cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()


class _Tile:
    """The context of one tile's program (what ``lax.axis_index`` and the
    collectives read)."""

    def __init__(self, run: _Run, k: int, j: int, i: int, shape, device,
                 axes):
        self.run, self.k, self.j, self.i = run, k, j, i
        self.shape, self.device = shape, device
        self.axes = axes              # (py name or None, px name or None)
        self.round = 0

    def coord(self, name: str) -> int:
        if name == self.axes[0]:
            return self.j
        if name == self.axes[1]:
            return self.i
        raise ValueError(f"axis {name!r} is not active here ({self.axes})")

    def size(self, name: str) -> int:
        self.coord(name)                  # raises for an inactive axis
        return self.shape[0] if name == self.axes[0] else self.shape[1]

    def exchange(self, operand):
        """Deposit ``operand``; once every tile has deposited this round,
        the grid (list of rows) of all tiles' operands."""
        run, r = self.run, self.round
        self.round += 1
        with run.cv:
            run.rounds.setdefault(r, [None] * run.n)[self.k] = operand
            run.deposits[r] = run.deposits.get(r, 0) + 1
            run.reads.setdefault(r, 0)
        run.hand_on(self.k)
        run.wait_turn(self.k)
        with run.cv:
            slots, full = run.rounds[r], run.deposits[r] == run.n
            run.reads[r] += 1
            if run.reads[r] == run.n:
                del run.rounds[r], run.deposits[r], run.reads[r]
        if not full:
            raise RuntimeError("shard_map: the tiles left lock step (a "
                               "program ended before a collective)")
        nx = self.shape[1]
        return [slots[j * nx:(j + 1) * nx] for j in range(self.shape[0])]


def _here() -> _Tile:
    t = getattr(_ctx, "tile", None)
    if t is None:
        raise RuntimeError("collectives run inside shard_map only")
    return t


def axis_index(name: str) -> int:
    return _here().coord(name)


def axis_size(name: str) -> int:
    return _here().size(name)


def current_device() -> torch.device:
    """The device of the tile whose program is running."""
    return _here().device


def _count(t: _Tile, kind: str) -> None:
    if t.k == 0:
        COLLECTIVES[kind] += 1


def all_tiles(operand):
    """Collective: every tile's ``operand``, as a grid, unmoved."""
    t = _here()
    _count(t, "psum")
    return t.exchange(operand)


def ppermute(x: torch.Tensor, name: str, perm):
    """Collective: for each (src, dst) pair of coordinates along axis
    ``name``, tile dst receives src's ``x`` (on dst's device); a tile that
    is no destination gets None (``lax.ppermute`` would give zeros; every
    caller here substitutes the mirror there)."""
    t = _here()
    _count(t, "ppermute")
    grid = t.exchange(x)
    me = t.coord(name)
    src = [s for s, d in perm if d == me]
    if not src:
        return None
    j, i = (src[0], t.i) if name == t.axes[0] else (t.j, src[0])
    return grid[j][i].to(t.device)


def psum(x: torch.Tensor, name: str) -> torch.Tensor:
    """Collective: the sum of ``x`` over the tiles along axis ``name``,
    in coordinate order, on this tile's device."""
    t = _here()
    _count(t, "psum")
    grid = t.exchange(x)
    line = ([grid[j][t.i] for j in range(t.shape[0])] if name == t.axes[0]
            else grid[t.j])
    s = line[0].to(t.device)
    for y in line[1:]:
        s = s + y.to(t.device)
    return s


def shard_map(fn, mesh: Mesh, axes=("py", "px")):
    """``fn`` run on every tile of the grid that ``axes`` (active mesh
    axes, None for a dropped one) gives ``mesh``.  The returned callable
    takes, per argument, a :class:`Tiles` of that grid (each program gets
    its tile) or any other value (every program gets it), and returns a
    Tiles (or a tuple of Tiles where ``fn`` returns a tuple).

    The programs run on threads, one at a time (:class:`_Run`), each under
    its device and, on the card, the caller's current stream there."""
    devices = mesh.tile_devices(axes)
    shape = (len(devices), len(devices[0]))

    def run(*args):
        COLLECTIVES["shard_map"] += 1
        for a in args:
            if isinstance(a, Tiles) and a.shape != shape:
                raise ValueError(f"tiles {a.shape} on a {shape} grid")
        n = shape[0] * shape[1]
        r = _Run(n)
        out = [None] * n
        streams = {d: torch.cuda.current_stream(d)
                   for row in devices for d in row if d.type == "cuda"}

        def body(k):
            j, i = divmod(k, shape[1])
            dev = devices[j][i]
            _ctx.tile = _Tile(r, k, j, i, shape, dev, axes)
            try:
                r.wait_turn(k)
                targs = [a.grid[j][i] if isinstance(a, Tiles) else a
                         for a in args]
                if dev.type == "cuda":
                    with torch.cuda.device(dev), \
                            torch.cuda.stream(streams[dev]):
                        out[k] = fn(*targs)
                else:
                    out[k] = fn(*targs)
            except _Aborted:
                pass
            except BaseException as exc:       # noqa: B902 - re-raised
                r.fail(exc)
            finally:
                _ctx.tile = None
                with r.cv:
                    r.done[k] = True
                r.hand_on(k)

        threads = [threading.Thread(target=body, args=(k,), daemon=True)
                   for k in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if r.error is not None:
            raise r.error
        if isinstance(out[0], tuple):
            return tuple(Tiles([[out[j * shape[1] + i][m]
                                 for i in range(shape[1])]
                                for j in range(shape[0])])
                         for m in range(len(out[0])))
        return Tiles([out[j * shape[1]:(j + 1) * shape[1]]
                      for j in range(shape[0])])

    return run
