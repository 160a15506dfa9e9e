"""Device-resident staged prover: every bulk stage is one captured CUDA
graph, replayed on each later prove of the same shapes.

Counterpart of valida_tpu/machine/jit_prover.py, whose stages are jitted
XLA calls.  Same transcript, stage names and proof bytes as
machine/prover.py:

  traces      op arrays -> [n, w] main traces (chip.build_trace)
  commit      trace -> coefficients, bit-reversed LDE, canonical rows;
              Merkle levels (one stage per tree, or per level when big,
              inside a span "merkle: <tree>"; the root's level apart)
  perm        main trace + challenges (+ preprocessed) -> flat permutation
              trace and cumulative sum
  quotient    LDEs + challenges + alpha + cumulative sum -> chunk matrix
  openings    coefficients + zeta -> opened values at the group's points
  reduced     LDEs + opened values + zeta + alpha -> reduced opening
  FRI         pair matrix, Merkle levels, the duplex challenge (absorb the
              root, sample beta) and the fold, per layer, on the card
  queries     one gather per tree (`DeviceTree.open_batch`)

Only Merkle roots, opened values and query openings come to the host:
the host challenger takes the roots between rounds, replays the FRI
ladder's challenges from one batched fetch of its roots, and grinds the
proof of work eagerly (commit/fri.py::grind_device).

A stage (`Stage`) is keyed by shapes and static parameters, as the JAX
package's stages are.  On a CPU tensor it runs its Python function.  On a
CUDA tensor its first call at a call site runs the function eagerly (that
builds the kernels, fills the `convert.table` caches and lets a caller
record the kernel calls), then captures it into a `torch.cuda.CUDAGraph`,
replays the graph and requires the replay's words to equal the eager
run's; every later call copies its inputs into the graph's static inputs
and replays.  A capture that fails raises: there is no eager fallback.
Everything a stage reads that depends on the transcript or on the program
(challenges, alpha, zeta, the cumulative sums, the preprocessed traces)
enters as an input tensor, never as a Python constant, which a graph would
bake in.

Call sites.  A graph's outputs are its static tensors, overwritten at its
next replay, so each call of a prove has a graph of its own, keyed by the
graph called just before it in this prove, the stage key and the producers
of its inputs (the graph and output index of an input that is another
stage's output, whose copy is then skipped).  The graphs of the proves made
so far thus form a tree of call sequences, and a prove replays one path of
it in the order the path was captured.  All graphs share one memory pool
(`torch.cuda.graph_pool_handle`) and one capture stream: a capture reuses
memory that earlier captures freed, which another graph may write at its
replay.  That is safe along a path, whose graphs replay one at a time in
capture order, so every graph writes its outputs after the graphs before it
wrote their scratch; and a path that leaves another captures every later
call anew, so it never replays a graph whose outputs might overlap its own
graphs' scratch.  Every static output stays allocated until
`release_graphs` drops them all.

The mesh (`prove_jit(mesh=..., row_axis=...)`).  Every rank of the
mesh's row axis runs the same prove on its shard (one process a device,
torch.distributed), with the JAX package's layout rule (its `_shard_of`):
an array whose rows the axis's D ranks divide is held as D contiguous row
blocks, one a rank; any other array whole on every rank.  The JAX package
lets GSPMD insert the collectives; here each mesh stage writes them out,
inside the stage (on the card they are captured into its graph with the
kernels, every rank capturing and replaying in the same order):
  traces      built whole on every rank, each keeps its block
  commit      `dist_coeffs` / `dist_extend` (all_to_alls) where
              `dif_applies`, else the rows gathered and extended whole;
              leaves and subtrees local, the block roots all_gathered and
              the top log2(D) levels (with the shorter, replicated
              matrices injected) built on every rank
  perm        local LogUp terms; the running sum's offset from one
              all_gather of the ranks' totals
  quotient    one all_to_all brings each rank its block of the quotient
              domain in natural order with a halo of 2^qd rows;
              `decompose_and_flatten` by `dist_coeffs`, one move of the
              chunks' coefficients and `dist_eval`; the chunk matrix is
              committed as the single-device prove commits it
  openings    local sums against bit-reversed powers of zeta, all_reduced
  FRI         folds local (a layer of D rows is gathered first)
  queries     the owner's rows and lower path, one masked all_reduce
A sharded coefficient matrix is held in bit-reversed row order, block by
block (the order the inverse `dist_dif` leaves it).  The challenger, the
grind and the FRI ladder run alike on every rank, so every rank assembles
the same proof, byte for byte the single-device one.  A mesh stage's key
ends with ("mesh", D, row_axis), and it reads the live group from _MESH.

Not ported from the JAX package: its persistent export cache and source
fingerprint (`_stage_cache_dir`, `_source_fingerprint`) are JAX-only (a
CUDA graph does not outlive its process); `_par_map`'s threads (capture is
not thread-safe: stages run in order) and the list of stage keys made
from the shapes alone, from which they compiled ahead of time (a graph is
captured by running its stage); the host-challenger FRI ladder (the
device one is the default there); the jitted grind attempt and
`_grind_entry_k`, its key; the row tiles of the permutation, openings and
reduced-opening stages and their environment variables.  Every stage here
runs its whole domain at once: on the card a tile multiplies a stage's
kernel launches, and the one-shot stages fit the memory the eager prover
already needs.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..air.check import check_constraints, check_cumulative_sums
from ..air.lookup import (generate_permutation_trace, perm_cols_and_terms,
                          phi_column)
from ..air.quotient import (decompose_and_flatten, get_log_quotient_degree,
                            quotient_rows, release_selector_tables)
from ..commit import fri as frim
from ..commit.pcs import (BatchOpening, PcsProof, PcsQueryProof,
                          _alpha_combine, _coset_points_bitrev,
                          observe_direct_polys)
from ..convert import (from_reference, index_tensor, table, to_numpy,
                       u32_as_int64)
from ..core.proof import ChipProof, Commitments, MachineProof, OpenedValues
from ..crypto import poseidon
from ..crypto.merkle import get_hasher, merkle_levels
from ..field import babybear as bb
from ..field import ext as extf
from ..parallel.dist_ntt import (COLLECTIVES, axis_info, count_collective,
                                 dif_applies, dist_coeffs, dist_eval,
                                 dist_extend, move_rows)
from ..poly import ntt as nttm
from ..utils import span, stage

# the largest Merkle tree built in one stage (bigger ones run a stage per
# level)
TREE_FUSE_MAX = 1 << 13

# host->device uploads of the current prove (reset at each prove_jit): the
# bytes of every host array it uploads
transfer_stats = {"bytes": 0}


def _upload(arr, device) -> torch.Tensor:
    """`from_reference(arr, device)`, counted in transfer_stats."""
    t = from_reference(arr, device)
    transfer_stats["bytes"] += t.nbytes
    return t


# ---------------------------------------------------------------------------
# the stage mechanism
# ---------------------------------------------------------------------------

_POOL = []  # [graph pool handle, capture stream] once the first capture ran
_GRAPHS: dict = {}  # (previous graph, stage key, input producers) -> _Graph
_OUTPUT_OF: dict = {}  # id(static output) -> (graph uid, output index)
_LAST = [None]  # uid of the graph the current prove called last
_UIDS = itertools.count()
STAGE_LOG: list = []  # stage keys of the current prove, in call order
stats = {"captures": 0}  # graphs captured in this process


class _Graph:
    __slots__ = ("uid", "graph", "inputs", "outputs", "out_spec", "launches",
                 "collectives")

    def __init__(self, graph, inputs, outputs, out_spec, launches,
                 collectives):
        self.uid = next(_UIDS)
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_spec = out_spec
        self.launches = launches
        self.collectives = collectives

    def replay(self):
        """Replay the graph; count the kernel launches and collectives it
        holds."""
        self.graph.replay()
        for k, n in self.launches.items():
            _build.LAUNCHES[k] += n
            _build.GRAPH_LAUNCHES[k] += n
        COLLECTIVES["replayed"] += self.collectives


def _flatten(obj):
    """Nested tuples/lists of tensors (and None) -> (leaves, spec)."""
    if isinstance(obj, (tuple, list)):
        leaves, specs = [], []
        for x in obj:
            sub, spec = _flatten(x)
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, (type(obj), specs)
    return [obj], None


def _unflatten(leaves, spec):
    if spec is None:
        return leaves[0]
    kind, specs = spec
    out, off = [], 0
    for n, sub in specs:
        out.append(_unflatten(leaves[off:off + n], sub))
        off += n
    return kind(out)


class Stage:
    """A stage function under its key (see the module docstring).  A call
    with a `label` runs the function, or replays the graph, inside a span
    of that name; the copies into the graph's static inputs stay under the
    enclosing range."""

    def __init__(self, key: tuple, fn):
        self.key = key
        self.fn = fn

    def __call__(self, *args, label: str | None = None):
        STAGE_LOG.append(self.key)
        leaves, spec = _flatten(args)
        dev = next(t.device for t in leaves if t is not None)
        if dev.type != "cuda":
            with span(label):
                return self.fn(*args)
        producers = tuple(None if t is None else _OUTPUT_OF.get(id(t))
                          for t in leaves)
        gkey = (_LAST[0], self.key, producers)
        g = _GRAPHS.get(gkey)
        if g is None:
            with span(f"capture: {self.key[0]}"):
                g = _GRAPHS[gkey] = self._capture(leaves, spec, producers)
        else:
            for static, a in zip(g.inputs, leaves):
                if a is not None and a is not static:
                    static.copy_(a)
            with span(label):
                g.replay()
        _LAST[0] = g.uid
        return _unflatten(g.outputs, g.out_spec)

    def _capture(self, leaves, spec, producers):
        eager = self.fn(*_unflatten(leaves, spec))
        inputs = [a if a is None or src is not None else a.clone()
                  for a, src in zip(leaves, producers)]
        if not _POOL:
            _POOL.extend([torch.cuda.graph_pool_handle(),
                          torch.cuda.Stream()])
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.CAPTURED)
        coll = COLLECTIVES["captured"]
        with torch.cuda.graph(graph, pool=_POOL[0], stream=_POOL[1]):
            out = self.fn(*_unflatten(inputs, spec))
        launches = {k: _build.CAPTURED[k] - n for k, n in before.items()}
        outputs, out_spec = _flatten(out)
        g = _Graph(graph, inputs, outputs, out_spec,
                   {k: n for k, n in launches.items() if n},
                   COLLECTIVES["captured"] - coll)
        stats["captures"] += 1
        g.replay()
        want, _ = _flatten(eager)
        if len(want) != len(outputs) or not all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(want, outputs)):
            raise RuntimeError(f"stage {self.key[0]}: the captured graph's "
                               f"replay differs from its eager run")
        for i, t in enumerate(outputs):
            if id(t) in _OUTPUT_OF or any(t is a for a in inputs):
                raise RuntimeError(f"stage {self.key[0]}: an output is "
                                   f"another stage's tensor")
            _OUTPUT_OF[id(t)] = (g.uid, i)
        return g


def release_graphs() -> None:
    """Drop every captured graph, its static tensors, the shared pool and
    the quotient's selector tables, which the graphs read (the caller
    drops its references to stage outputs too; then
    `torch.cuda.empty_cache()` returns the memory)."""
    _GRAPHS.clear()
    _OUTPUT_OF.clear()
    _LAST[0] = None
    _POOL.clear()
    release_selector_tables()


def _begin_prove() -> None:
    _LAST[0] = None
    STAGE_LOG.clear()


def _shape(t) -> tuple:
    return tuple(int(x) for x in t.shape)


def _keyed(key: tuple, mk) -> tuple:
    """A stage key, with the mesh key of a mesh prove at its end."""
    return key if mk is None else key + (mk,)


# ---------------------------------------------------------------------------
# the mesh: layout and collectives (see the module docstring)
# ---------------------------------------------------------------------------


class _Mesh:
    """The row axis of a mesh prove: D ranks, this rank's index r, the
    axis's process group; key ("mesh", D, row_axis) ends its stage keys."""

    def __init__(self, mesh, row_axis: str):
        self.mesh, self.axis = mesh, row_axis
        self.d, self.r, self.group = axis_info(mesh, row_axis)
        self.key = ("mesh", self.d, row_axis)


_MESH = [None]  # the _Mesh of the mesh prove under way


def _sharded(h: int, mk) -> bool:
    """Whether an array of h rows is row-sharded in a prove with mesh key
    mk (the JAX package's `_shard_of`)."""
    return mk is not None and h % mk[1] == 0


def _row_start(h: int, mk) -> int:
    """The first global row of this rank's block of an array of h rows (0
    for a whole array)."""
    return _MESH[0].r * (h // mk[1]) if _sharded(h, mk) else 0


def _block_of(x: torch.Tensor, mk) -> torch.Tensor:
    """This rank's row block of a whole array that the mesh shards; x
    itself when it is not sharded, or at D = 1."""
    h = int(x.shape[0])
    if not _sharded(h, mk) or mk[1] == 1:
        return x
    b = h // mk[1]
    return x[_row_start(h, mk):][:b].clone()


def _host_block(a: np.ndarray, mk) -> np.ndarray:
    """`_block_of` of a host array."""
    h = int(a.shape[0])
    if not _sharded(h, mk):
        return a
    b = h // mk[1]
    return a[_row_start(h, mk):][:b]


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[D·n, ...]: the [n, ...] blocks of every rank of the row axis, in
    rank order (one all_gather)."""
    m = _MESH[0]
    parts = [torch.empty_like(x) for _ in range(m.d)]
    count_collective()
    dist.all_gather(parts, x.contiguous(), group=m.group)
    return torch.cat(parts, dim=0)


def _sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """The field sum over the row axis's ranks of x (words below p): one
    int64 all_reduce, then mod p."""
    s = x.to(torch.int64)
    count_collective()
    dist.all_reduce(s, group=_MESH[0].group)
    return (s % bb.P).to(torch.int32)


def _bitrev_int(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


@functools.lru_cache(maxsize=None)
def _gather_stage(shape, mk):
    """A row-sharded array [h, ...] -> the whole array on every rank."""
    return Stage(("gather", shape, mk), _gather_rows)


# ---------------------------------------------------------------------------
# device Merkle forest (mixed heights, like crypto/merkle.MerkleTree)
# ---------------------------------------------------------------------------


class DeviceTree:
    """A Merkle tree whose matrices and levels stay on the device, with a
    batched query opening (one gather stage per tree).  In a mesh prove
    (mesh key mk) a matrix of global height heights[i] that the ranks
    divide is this rank's row block, and so is each level above log2(D);
    the levels at and below it are whole on every rank."""

    def __init__(self, mats, root, levels, heights=None, mk=None):
        self.mats = mats  # canonical [h, w] tensors
        self._root = root  # [8] tensor, fetched on first use (.root)
        self.levels = levels  # {k: [2^k, 8] digests}
        self.log_max = max(levels)
        self.heights = heights or [int(m.shape[0]) for m in self.mats]
        self.mk = mk

    @property
    def root(self) -> np.ndarray:
        if not isinstance(self._root, np.ndarray):
            self._root = to_numpy(self._root)
        return self._root

    def open_batch(self, indices: np.ndarray):
        """indices: [q] leaf indices -> (rows per matrix: [q, w] each,
        paths [q, log_max, 8]), left on the device for one batched fetch
        of all trees (`_fetch_all`)."""
        dev = self.mats[0].device
        idx = _upload(np.asarray(indices, dtype=np.uint32), dev).long()
        if self.log_max == 0:
            return ([m.index_select(0, idx * 0) for m in self.mats],
                    np.zeros((len(indices), 0, 8), dtype=np.uint32))
        levels = tuple(self.levels[k] for k in range(self.log_max, 0, -1))
        fn = _open_batch_stage(
            tuple((h, int(m.shape[1])) for h, m in zip(self.heights,
                                                       self.mats)),
            tuple((1 << k, 8) for k in range(self.log_max, 0, -1)),
            self.log_max, len(indices), self.mk)
        rows, paths = fn(tuple(self.mats), levels, idx)
        return list(rows), paths


def _log2(h: int) -> int:
    return int(h).bit_length() - 1


@functools.lru_cache(maxsize=None)
def _open_batch_stage(mat_shapes, level_shapes, log_max, q, mk=None):
    """Batched Merkle query opening of one tree signature (global shapes):
    the opened rows of every matrix and the sibling paths, in one stage.
    In a mesh prove the rank that holds a query's leaf supplies its rows
    of the sharded matrices and its siblings above log2(D), the others
    zeros, and one int32 all_reduce (a sum with one term) gives every rank
    all of them."""
    logd = _log2(mk[1]) if mk is not None else 0

    def fn(mats, levels, idx):
        owned = []  # (list, index) of each sharded array's part
        mine = ((idx >> (log_max - logd)) == _MESH[0].r
                if mk is not None and log_max >= logd else None)

        def take(a, gi, sharded, h, out):
            """Rows gi of a (h rows); of a sharded one, the owner's."""
            if sharded:
                owned.append((out, len(out)))
                out.append(a.index_select(
                    0, (gi - _row_start(h, mk)).masked_fill(~mine, 0))
                    .masked_fill(~mine[:, None], 0))
            else:
                out.append(a.index_select(0, gi))

        rows, sibs, cur = [], [], idx
        for m, (h, _w) in zip(mats, mat_shapes):
            take(m, idx >> (log_max - _log2(h)), _sharded(h, mk), h, rows)
        for level, (h, _w) in zip(levels, level_shapes):
            # a level of D digests or fewer is whole on every rank
            take(level, cur ^ 1, _sharded(h, mk) and h > 1 << logd, h, sibs)
            cur = cur >> 1
        if owned:
            parts = [out[i] for out, i in owned]
            flat = torch.cat([t.reshape(-1) for t in parts])
            count_collective()  # int32 words, digests too: no mod p
            dist.all_reduce(flat, group=_MESH[0].group)
            off = 0
            for (out, i), t in zip(owned, parts):
                out[i] = flat[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
        return tuple(rows), torch.stack(sibs, dim=1)

    return Stage(_keyed(("openbatch", mat_shapes, level_shapes, log_max, q),
                        mk), fn)


def _cat_cols(mats) -> torch.Tensor:
    return (torch.cat(list(mats), dim=1) if len(mats) > 1
            else mats[0]).contiguous()


@functools.lru_cache(maxsize=None)
def _leaf_hash_jit(shapes, hasher_name, mk=None):
    """Hash the row-wise concatenation of matrices of `shapes`."""
    h = get_hasher(hasher_name)
    return Stage(_keyed(("hashcat", shapes, hasher_name), mk),
                 lambda mats: h.hash_words(_cat_cols(mats)))


@functools.lru_cache(maxsize=None)
def _pair_hash_jit(n, hasher_name, mk=None):
    """One Merkle compression level: [n, 8] -> [n/2, 8]."""
    h = get_hasher(hasher_name)
    return Stage(_keyed(("hashpair", n, hasher_name), mk),
                 lambda d: h.hash_words(d.reshape(-1, 16)))


@functools.lru_cache(maxsize=None)
def _tree_stage(mat_shapes, hasher_name, mk=None):
    """A Merkle forest (mixed heights, level injection) but its root in
    one stage: matrices in, the digest levels log_max .. 1 out (the leaf
    level alone where log_max is 0)."""

    def fn(mats):
        _first, levels = merkle_levels(list(mats), hasher_name, low=1)
        return tuple(levels[k] for k in sorted(levels, reverse=True))

    return Stage(_keyed(("tree", mat_shapes, hasher_name), mk), fn)


@functools.lru_cache(maxsize=None)
def _tree_top_stage(d, rep_shapes, hasher_name, mk):
    """The top log2(D) levels of a mesh tree: every rank's block root
    [1, 8] all_gathered into level log2(D), then compressed to the root,
    the whole matrices (heights below D, `rep_shapes`) injected at their
    levels as `merkle_levels` injects them.  Levels log2(D) .. 0 out."""
    h = get_hasher(hasher_name)
    by_level = _by_level(rep_shapes)

    def fn(block_root, rep):
        cur = _gather_rows(block_root)
        out = [cur]
        for k in range(_log2(d) - 1, -1, -1):
            cur = h.hash_words(cur.reshape(-1, 16))
            if k in by_level:
                inj = h.hash_words(_cat_cols([rep[i] for i in by_level[k]]))
                cur = h.hash_words(torch.cat([cur, inj], dim=1))
            out.append(cur)
        return tuple(out)

    return Stage(("treetop", d, rep_shapes, hasher_name, mk), fn)


def _by_level(shapes) -> dict:
    by_level: dict = {}
    for i, (h, _w) in enumerate(shapes):
        by_level.setdefault(_log2(h), []).append(i)
    return by_level


def _build_levels_jit(mats, hasher_name, label, mk=None):
    """(root [8] tensor, {k: digests}): one fused stage for a small tree,
    a stage per level for a big one, then a stage for the root's level.
    The span `label` ("merkle: main") holds every level but the root's,
    which stays in the caller's range: a profiler draws a range on the
    card's timeline from the first operation it holds to the last, so a
    stage whose last work is a tree keeps its whole extent."""
    shapes = tuple(_shape(m) for m in mats)
    by_level = _by_level(shapes)
    log_max = max(by_level)

    def leaf(group):
        return _leaf_hash_jit(tuple(_shape(m) for m in group),
                              hasher_name, mk)(tuple(group))

    def below(k, d):
        """Level k from level k + 1."""
        d = _pair_hash_jit(1 << (k + 1), hasher_name, mk)(d)
        if k in by_level:
            d = leaf([d, leaf([mats[i] for i in by_level[k]])])
        return d

    with span(label):
        if (1 << log_max) <= TREE_FUSE_MAX:
            outs = _tree_stage(shapes, hasher_name, mk)(tuple(mats))
            levels = {log_max - i: a for i, a in enumerate(outs)}
        else:
            levels = {log_max: leaf([mats[i] for i in by_level[log_max]])}
            for k in range(log_max - 1, 0, -1):
                levels[k] = below(k, levels[k + 1])
    if log_max:
        levels[0] = below(0, levels[1])
    return levels[0][0], levels


def _build_levels_mesh(mats, shapes, hasher_name, label, mk):
    """`_build_levels_jit` of a mesh prove (shapes global): the sharded
    matrices' blocks are a subtree on each rank, built locally down to its
    root; `_tree_top_stage` makes the top, outside the span `label`.
    Levels above log2(D) are this rank's blocks, the rest whole."""
    d = mk[1]
    local = [i for i, (h, _w) in enumerate(shapes) if h % d == 0]
    if not local:
        return _build_levels_jit(mats, hasher_name, label, mk)
    _r, below = _build_levels_jit([mats[i] for i in local], hasher_name,
                                  label, mk)
    rep = [i for i in range(len(mats)) if i not in local]
    top = _tree_top_stage(d, tuple(shapes[i] for i in rep), hasher_name,
                          mk)(below[0], tuple(mats[i] for i in rep))
    logd = _log2(d)
    levels = {k + logd: a for k, a in below.items() if k}
    levels.update({logd - i: a for i, a in enumerate(top)})
    return levels[0][0], levels


# ---------------------------------------------------------------------------
# stage factories (cached by their static signature)
# ---------------------------------------------------------------------------


def _lde(m, dshift, log_blowup, shift):
    """Montgomery evaluations on dshift·H_h -> (coefficients, LDE in
    bit-reversed row order, both Montgomery; the canonical LDE rows the
    tree commits), as `TwoAdicFriPcs.commit_batches` makes them."""
    coeffs = nttm.intt(m) if dshift == 1 else nttm.coset_intt(m, dshift)
    pad = coeffs.new_zeros((((1 << log_blowup) - 1) * coeffs.shape[0],)
                           + tuple(coeffs.shape[1:]))
    lde_rev = nttm.coset_eval_from_coeffs(torch.cat([coeffs, pad]), shift,
                                          out_bitrev=True)
    return coeffs, lde_rev, bb.from_monty(lde_rev)


@functools.lru_cache(maxsize=None)
def _lde_stage(shape, dshift, log_blowup, shift):
    """One trace matrix (canonical) -> `_lde`'s three outputs."""
    return Stage(("lde", shape, dshift, log_blowup, shift),
                 lambda mat: _lde(bb.to_monty(mat), dshift, log_blowup,
                                  shift))


@functools.lru_cache(maxsize=None)
def _mesh_lde_stage(shape, dshift, log_blowup, shift, mk):
    """`_lde_stage` of a mesh prove (shape global, mat in the mesh layout),
    its outputs in the mesh layout: a sharded matrix's coefficients in
    bit-reversed order, block by block.  `dist_coeffs` and `dist_extend`
    where `dif_applies`; else the rows gathered, extended whole and
    blocked again."""
    h, log_h = shape[0], _log2(shape[0])

    def fn(mat):
        m, mesh = bb.to_monty(mat), _MESH[0]
        if _sharded(h, mk) and dif_applies(log_h, mk[1]):
            c = dist_coeffs(m, mesh.mesh, mesh.axis, dshift)
            lde_rev = dist_extend(c, mesh.mesh, log_blowup, shift, mesh.axis)
            return c, lde_rev, bb.from_monty(lde_rev)
        if _sharded(h, mk):
            c, lde_rev, canon = _lde(_gather_rows(m), dshift, log_blowup,
                                     shift)
            c = nttm._gather_bitrev(c, log_h)
        else:
            c, lde_rev, canon = _lde(m, dshift, log_blowup, shift)
        return _block_of(c, mk), _block_of(lde_rev, mk), _block_of(canon, mk)

    return Stage(("lde", shape, dshift, log_blowup, shift, mk), fn)


def _ext_powers_dyn(z, n: int):
    """[n, 5] Montgomery powers of a [5] Montgomery ext tensor."""
    arr = extf.ext_one(z.device)[None, :]
    cur = z[None, :]
    length = 1
    while length < n:
        arr = torch.cat([arr, extf.ext_mul(arr, cur)], dim=0)
        cur = extf.ext_mul(cur, cur)
        length *= 2
    return arr[:n]


def _points_for(zeta_m, kind):
    """The opening points of a point kind: ("pair", log_h) -> zeta and
    zeta * g_h; ("pow", qd) -> zeta^(2^qd)."""
    tag, param = kind
    if tag == "pair":
        g = bb.monty_scalar(bb.two_adic_generator(param))
        return [zeta_m, bb.mul(zeta_m, g)]
    zq = zeta_m
    for _ in range(param):
        zq = extf.ext_mul(zq, zq)
    return [zq]


@functools.lru_cache(maxsize=None)
def _openings_stage(shapes, kind, mk=None):
    """Open all coefficient matrices of one (height, point kind) group at
    the kind's points: a [sum of widths, 5] Montgomery tensor per point."""
    h = shapes[0][0]
    if _sharded(h, mk):
        return _mesh_openings_stage(shapes, kind, mk)

    def fn(mats, zeta_m):
        coeffs = torch.cat(mats, dim=1) if len(mats) > 1 else mats[0]
        out = []
        for z in _points_for(zeta_m, kind):
            zp = _ext_powers_dyn(z, h)
            out.append(nttm.eval_at_ext_point(coeffs, zp))
        return tuple(out)

    return Stage(_keyed(("open", shapes, kind), mk), fn)


@functools.lru_cache(maxsize=None)
def _mesh_openings_stage(shapes, kind, mk):
    """`_openings_stage` of row-sharded coefficients.  Row j of rank r's
    block holds coefficient i = bitrev(r·h/D + j) = bitrev'(j)·D + rev(r)
    (bitrev' over log2(h/D) bits, rev over log2(D)), so the block's sum is
    z^rev(r) · sum_j c_j (z^D)^bitrev'(j): the powers of z^D, gathered in
    bit-reversed order; then the ranks' sums are added."""
    d = mk[1]
    hb = shapes[0][0] // d

    def fn(mats, zeta_m):
        coeffs = _cat_cols(mats)
        rev = table(nttm.bitrev_indices, _log2(hb),
                    device=coeffs.device).long()
        rr = _bitrev_int(_MESH[0].r, _log2(d))
        out = []
        for z in _points_for(zeta_m, kind):
            zp = _ext_powers_dyn(extf.ext_exp(z, d), hb).index_select(0, rev)
            part = extf.ext_mul(nttm.eval_at_ext_point(coeffs, zp),
                                extf.ext_exp(z, rr)[None, :])
            out.append(_sum_ranks(part))
        return tuple(out)

    return Stage(("open", shapes, kind, mk), fn)


@functools.lru_cache(maxsize=None)
def _reduced_stage(shapes, kind, log_lde, col_offs, shift, mk=None):
    """Reduced-opening contribution of one (height, point kind) group:
    sum over its points z of (sum_c alpha^off(c) (p_c(x) - p_c(z))) /
    (x - z) on the bit-reversed LDE domain, [2^log_lde, 5] Montgomery.
    col_offs[c] is column c's alpha-power index in the global matrix
    order.  The same words as `open_multi_batches`' per-matrix sums
    (field sums are exact).  In a mesh prove the LDEs are this rank's
    blocks, against its rows of the points: every row is its own."""
    widths = [w for _h, w in shapes]
    n_pows = max(col_offs) + 1

    def fn(ldes_rev, vals, zeta_m, alpha_m):
        dev = zeta_m.device
        apows = _ext_powers_dyn(alpha_m, n_pows).index_select(
            0, index_tensor(col_offs, dev))
        starts = list(itertools.accumulate([0] + widths))
        member_pows = [apows[a:b] for a, b in zip(starts[:-1], starts[1:])]
        points = _points_for(zeta_m, kind)
        comb_ys = [nttm._mod_sum(extf.ext_mul(apows, y), axis=0)
                   for y in vals]
        q = int(ldes_rev[0].shape[0])
        x0 = _row_start(1 << log_lde, mk)
        xs = table(_coset_points_bitrev, log_lde, shift,
                   device=dev)[x0:x0 + q]
        combined = None
        for lde, ap in zip(ldes_rev, member_pows):
            c = _alpha_combine(lde, ap)
            combined = c if combined is None else bb.add(combined, c)
        denoms = torch.stack([bb.sub(extf.ext_from_base(xs), z[None, :])
                              for z in points])
        inv_denoms = extf.ext_inv(denoms)
        acc = None
        for y, inv in zip(comb_ys, inv_denoms):
            quot = extf.ext_mul(bb.sub(combined, y[None, :]), inv)
            acc = quot if acc is None else bb.add(acc, quot)
        return acc

    return Stage(_keyed(("red", shapes, kind, log_lde, col_offs, shift),
                        mk), fn)


@functools.lru_cache(maxsize=None)
def _fri_pair_mat(log_m, mk=None):
    """A FRI layer [2^log_m, 5] Montgomery -> its committed pair matrix
    [2^(log_m-1), 10] canonical (a row block of each in a mesh prove)."""
    return Stage(_keyed(("fripair", log_m), mk), frim._ext_to_base_matrix)


@functools.lru_cache(maxsize=None)
def _fri_fold(log_m, shift_layer, inject=False, mk=None):
    """FRI arity-2 fold; with inject the next height's reduced opening is
    added in the same stage.  In a mesh prove a fold pairs adjacent rows
    of the rank's block, against its rows of the 1/x0 table."""
    half = 1 << (log_m - 1)

    def fold(current, beta_m):
        x0 = _row_start(half, mk)
        x0inv = table(frim._x0_inv_table, log_m, shift_layer,
                      device=current.device)[x0:x0 + current.shape[0] // 2]
        return frim.fold_device(current, beta_m, x0inv)

    if inject:
        def fn(current, beta_m, inj):
            return bb.add(fold(current, beta_m), inj)
    else:
        fn = fold
    return Stage(_keyed(("frifold", log_m, shift_layer, inject), mk), fn)


@functools.lru_cache(maxsize=None)
def _add_stage(shape, mk=None):
    """Elementwise modular add (reduced openings of groups sharing a
    height)."""
    return Stage(_keyed(("addmod", shape), mk), bb.add)


@functools.lru_cache(maxsize=None)
def _ladder_challenge_stage(k0, param_set, mk=None):
    """One FRI-ladder Fiat-Shamir round on the card: absorb an 8-word
    Merkle root into the duplex state as `DuplexChallenger.observe` does,
    then sample one ext challenge (5 words popped from the state's end).
    k0: the input buffer's length on entry (0 after the first layer).
    State in and out canonical int32 [16]; returns (state, beta [5]
    Montgomery).  The key carries the Poseidon parameter set (pass
    poseidon.PARAM_SET), whose constants the graph reads."""
    width = poseidon.WIDTH

    def permute(st):
        return bb.from_monty(poseidon.permute_device(bb.to_monty(st)))

    def absorb_sample(state, buf):
        n = int(buf.shape[0])
        st = state
        if n >= width:
            st = permute(buf[:width])
            buf = buf[width:]
            n -= width
        # a sample duplexes when inputs are pending; a state just permuted
        # by a full buffer is popped as it is
        if n:
            st = permute(torch.cat([buf, st[n:]]))
        return st, bb.to_monty(st[width - 5:].flip(0))

    def words(root):
        return (u32_as_int64(root) % bb.P).to(torch.int32)

    if k0:
        def fn(state, pending, root):
            return absorb_sample(state, torch.cat([pending, words(root)]))
    else:
        def fn(state, root):
            return absorb_sample(state, words(root))
    return Stage(_keyed(("frichal", k0, param_set), mk), fn)


@functools.lru_cache(maxsize=None)
def _stack_canon_stage(n, mk=None):
    """Stack n [5] Montgomery cumulative sums, canonical (one fetch)."""
    return Stage(_keyed(("stackcanon", n), mk),
                 lambda vals: bb.from_monty(torch.stack(vals)))


_PERM_STAGE_CACHE: dict = {}
_QUOTIENT_STAGE_CACHE: dict = {}
_TRACE_STAGE_CACHE: dict = {}


def _trace_stage(machine, chip, shapes, meta, mk=None):
    """The chip's main trace from its uploaded op arrays (chip.build_trace);
    in a mesh prove, built whole on every rank, each keeping its block."""
    key = _keyed(("tracegen", type(machine).__name__, chip.name, shapes,
                  meta), mk)
    fn = _TRACE_STAGE_CACHE.get(key)
    if fn is None:
        fn = _TRACE_STAGE_CACHE[key] = Stage(
            key, lambda *inputs: _block_of(chip.build_trace(inputs, meta),
                                           mk))
    return fn


def _perm_stage(machine, chip, log_degree, width, prep_shape=None, mk=None):
    """Main trace, challenges [3, 5] canonical (and the preprocessed trace,
    an input: a program's ROM is content, not shape) -> (the flat
    canonical permutation trace [n, (K+1)*5], the cumulative sum [5]
    Montgomery).  In a mesh prove that shards the n rows: this rank's
    blocks in (the preprocessed trace zero-padded to n rows) and out, phi's
    offset the sum of the lower ranks' totals (one all_gather), the
    cumulative sum on every rank."""
    n = 1 << log_degree
    key = _keyed(("perm", type(machine).__name__, chip.name, log_degree,
                  width, prep_shape), mk)
    fn = _PERM_STAGE_CACHE.get(key)
    if fn is not None:
        return fn

    def perm_full(main_trace, ch_arr, prep):
        t = generate_permutation_trace(machine, chip, main_trace, ch_arr,
                                       prep=prep)
        return (bb.from_monty(t).reshape(n, t.shape[1] * 5),
                t[-1, -1].clone())

    def perm_mesh(main_trace, ch_arr, prep):
        rows = int(main_trace.shape[0])
        cols, terms = perm_cols_and_terms(
            machine, chip, bb.to_monty(main_trace),
            bb.to_monty(prep) if prep is not None else None, ch_arr)
        if not cols:
            return (main_trace.new_zeros((rows, 5)),
                    main_trace.new_zeros((5,)))
        totals = _gather_rows(nttm._mod_sum(terms, axis=0)[None, :])
        phi = phi_column(terms, nttm._mod_sum(totals[:_MESH[0].r], axis=0))
        t = torch.stack(cols + [phi], dim=1)
        return (bb.from_monty(t).reshape(rows, -1),
                nttm._mod_sum(totals, axis=0))

    impl = perm_mesh if _sharded(n, mk) else perm_full
    if prep_shape is None:
        def stage_fn(main_trace, ch_arr):
            return impl(main_trace, ch_arr, None)
    else:
        def stage_fn(main_trace, prep, ch_arr):
            return impl(main_trace, ch_arr, prep)
    fn = _PERM_STAGE_CACHE[key] = Stage(key, stage_fn)
    return fn


def _quotient_stage(machine, chip, log_degree, qd, shapes, shift,
                    log_blowup, mk=None):
    """Bit-reversed LDEs (preprocessed or None, main, permutation),
    challenges [3, 5], alpha [5] and the cumulative sum [5], canonical ->
    the quotient chunk matrix [n, 2^qd * 5] canonical (in a mesh prove, LDEs
    and chunk matrix in the mesh layout)."""
    key = _keyed(("quot", type(machine).__name__, chip.name, log_degree, qd,
                  shapes, shift, log_blowup), mk)
    fn = _QUOTIENT_STAGE_CACHE.get(key)
    if fn is not None:
        return fn

    def stage_fn(prep_lde, main_lde, perm_lde, ch_arr, alpha_arr, cum):
        # the bit-reversed LDEs read in place: natural row r of the
        # quotient domain is LDE row bitrev(r·2^(log_blowup - qd))
        qv = quotient_rows(machine, chip, log_degree, qd, prep_lde, main_lde,
                           perm_lde, cum, ch_arr, alpha_arr, shift,
                           stride=1 << (log_blowup - qd), bitrev=True)
        return decompose_and_flatten(qv, shift, qd)

    def stage_whole(*args):
        """A mesh prove's chip of fewer rows than D (its LDEs may still be
        sharded: they are gathered)."""
        shapes_ppm = (shapes[2], shapes[0], shapes[1])  # prep, main, perm
        ldes = [a if a is None or not _sharded(s[0], mk) else _gather_rows(a)
                for a, s in zip(args[:3], shapes_ppm)]
        return stage_fn(*ldes, *args[3:])

    log_q = log_degree + qd

    def stage_mesh(prep_lde, main_lde, perm_lde, ch_arr, alpha_arr, cum):
        m = _MESH[0]
        qb = (1 << log_q) // m.d

        def rows(lde):  # this rank's block of the domain, and its halo
            if lde is None:
                return None
            return move_rows(lde, m.mesh, m.axis, _quotient_wanted,
                             (log_q, qd))

        qv = quotient_rows(machine, chip, log_degree, qd, rows(prep_lde),
                           rows(main_lde), rows(perm_lde), cum, ch_arr,
                           alpha_arr, shift, m.r * qb, rows=qb)
        if not dif_applies(log_degree, m.d):
            return _block_of(decompose_and_flatten(_gather_rows(qv), shift,
                                                   qd), mk)
        # decompose_and_flatten on the mesh: the coefficients, each rank's
        # block of the chunks' (one move), evaluated on shift^(2^qd)·H_N
        c = dist_coeffs(qv, m.mesh, m.axis, shift)
        c = move_rows(c, m.mesh, m.axis, _chunk_wanted,
                      (log_degree, qd)).reshape(-1, (1 << qd) * 5)
        return bb.from_monty(dist_eval(c, m.mesh, bb.h_exp(shift, 1 << qd),
                                       m.axis))

    impl = (stage_fn if mk is None else
            stage_mesh if _sharded(1 << log_degree, mk) else stage_whole)
    fn = _QUOTIENT_STAGE_CACHE[key] = Stage(key, impl)
    return fn


def _quotient_wanted(d: int, q: int, log_q: int, qd: int) -> np.ndarray:
    """The bit-reversed LDE's rows that rank q evaluates the quotient on:
    the quotient domain's points k (natural order, its block and a halo of
    2^qd rows, wrapping round) are the LDE's rows bitrev_Q(k), Q =
    2^log_q, the first Q rows of the bit-reversed LDE."""
    qb = (1 << log_q) // d
    k = np.arange(q * qb, (q + 1) * qb + (1 << qd)) % (1 << log_q)
    return nttm.bitrev_indices(log_q)[k]


def _chunk_wanted(d: int, q: int, log_n: int, qd: int) -> np.ndarray:
    """The rows of the quotient's coefficients (bit-reversed over Q = N ·
    2^qd) that make rank q's block of the chunk coefficients, bit-reversed
    over N: row j' of that matrix holds, at column block c, the row c·N +
    j' of the Q-point array (coefficient bitrev_N(j')·2^qd + bitrev(c),
    of chunk bitrev(c), as `decompose_and_flatten` orders the chunks)."""
    nb = (1 << log_n) // d
    j = np.arange(q * nb, (q + 1) * nb)
    return ((np.arange(1 << qd) << log_n)[None, :] + j[:, None]).ravel()


def _from_monty_host(a: np.ndarray) -> np.ndarray:
    return (np.asarray(a, dtype=np.uint64) * np.uint64(bb.R_INV)
            % np.uint64(bb.P)).astype(np.uint32)


def _to_ext_tuples(arr) -> list:
    return [tuple(int(x) for x in row) for row in np.asarray(arr)]


def _fetch_all(arrs) -> list:
    """One copy to the host for a list of int32 device tensors (numpy
    arrays pass through)."""
    out = list(arrs)
    dev = [(i, a) for i, a in enumerate(arrs) if isinstance(a, torch.Tensor)]
    if dev:
        host = to_numpy(torch.cat([a.reshape(-1) for _i, a in dev]))
        off = 0
        for i, a in dev:
            out[i] = host[off:off + a.numel()].reshape(tuple(a.shape))
            off += a.numel()
    return out


# ---------------------------------------------------------------------------
# the shapes of a prove
# ---------------------------------------------------------------------------


def _opening_layout(all_mats, log_blowup, fri_config):
    """From the opened matrices [(coefficient shape, point kind)] in
    transcript order: (direct set, groups {(log_h, kind): [matrix]},
    alpha-power offset of each matrix)."""
    threshold = frim.direct_open_threshold(fri_config)
    log_max_all = max(_log2(h) + log_blowup for (h, _w), _k in all_mats)
    direct = {mi for mi, ((h, _w), _k) in enumerate(all_mats)
              if frim.is_direct_mat(_log2(h) + log_blowup, log_max_all,
                                    threshold)}
    groups: dict = {}
    offs, off = [], 0
    for mi, ((h, w), kind) in enumerate(all_mats):
        offs.append(off)
        if mi not in direct:
            off += w
            groups.setdefault((_log2(h), kind), []).append(mi)
    return direct, groups, offs


def _col_offs(all_mats, offs, members) -> tuple:
    return tuple(offs[mi] + j for mi in members
                 for j in range(all_mats[mi][0][1]))


def _padded_host(p: np.ndarray, n: int) -> np.ndarray:
    """A preprocessed trace zero-padded (or cut) to n rows, as
    `padded_prep` makes it."""
    if p.shape[0] < n:
        p = np.concatenate([p, np.zeros((n - p.shape[0], p.shape[1]),
                                        dtype=p.dtype)])
    return p[:n]


def _mesh_of(mesh, row_axis: str, device):
    """The _Mesh of a prove on `mesh` (None without one)."""
    if mesh is None:
        return None
    if torch.device(mesh.device_type).type != torch.device(device).type:
        raise ValueError(f"a mesh of {mesh.device_type} devices for a prove "
                         f"on {device}")
    return _Mesh(mesh, row_axis)


def warmup_jit(machine, config, mesh=None, row_axis: str = "sp") -> int:
    """Capture every stage a prove of this machine's shapes calls, by one
    `prove_jit` whose proof is dropped (the graphs keep their call sites in
    prove order, so a later prove of the same shapes only replays).  With a
    mesh, the stages of `prove_jit(mesh=mesh, row_axis=row_axis)` (every
    rank calls it).  Returns the number of stage calls of one prove,
    `len(STAGE_LOG)`."""
    prove_jit(machine, config, mesh, row_axis)
    return len(STAGE_LOG)


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------


def prove_jit(machine, config, mesh=None, row_axis: str = "sp"
              ) -> MachineProof:
    """Prove `machine` on config.pcs.device through the staged path; the
    proof's bytes equal `Machine.prove`'s.  mesh: a `parallel.mesh.
    make_mesh` mesh whose axis `row_axis` shards the rows (every rank of
    the process group calls this; each gets the same proof).  With
    config.debug_checks on, a mesh prove gathers every main and
    permutation trace outside the stages for the checks: on the card those
    are eager collectives, up to two a chip.  The keys of the stages it
    called, in call order, are left in STAGE_LOG: a prove of the same
    shapes calls the same keys in the same order, which the graphs' tree
    of call sites relies on.  A row axis the mesh lacks raises
    ValueError."""
    _MESH[0] = _mesh_of(mesh, row_axis, config.pcs.device)
    try:
        return _prove(machine, config,
                      _MESH[0].key if _MESH[0] is not None else None)
    finally:
        _MESH[0] = None


def _prove(machine, config, mk) -> MachineProof:
    # the host's stretches outside the stages are spans "prove: ..."
    with span("prove: setup"):
        _begin_prove()
        transfer_stats["bytes"] = 0
        chips = machine.chips()
        pcs = config.pcs
        fri_config = pcs.config
        dev = pcs.device
        shift, log_blowup = pcs.coset_shift(), pcs.log_blowup
        hasher = fri_config.hasher
        challenger = config.challenger()
        qds = [get_log_quotient_degree(machine, c) for c in chips]

    # -- traces (in the mesh layout: this rank's blocks) ---------------------
    with span("prove: preprocessed traces"):
        prep_indices, prep_host, prep_list = {}, [], []
        for ci, c in enumerate(chips):
            p = c.preprocessed_trace()
            if p is not None:
                prep_indices[ci] = len(prep_list)
                prep_host.append(np.asarray(p, dtype=np.uint32))
                prep_list.append(_upload(_host_block(prep_host[-1], mk), dev))
        prep_shapes = [tuple(int(x) for x in p.shape) for p in prep_host]
    heights = []

    def chip_span(layer, ci):
        """The span of chip ci's run or replay inside a stage ("main
        trace: cpu"), or None for the last chip: a profiler gives each
        device operation to the innermost range open at its launch and
        draws a range on the card's timeline from the first operation it
        holds to the last, so the stage keeps its last replay and its own
        range still covers all its work."""
        return None if ci == len(chips) - 1 else f"{layer}: {chips[ci].name}"

    def one_trace(ci, c):
        with span(f"trace inputs: {c.name}"):
            dti = c.device_trace_inputs(machine)
            t = (np.asarray(c.generate_trace(machine), dtype=np.uint32)
                 if dti is None else None)
        if t is not None:
            heights.append(int(t.shape[0]))
            return _upload(_host_block(t, mk), dev)
        inputs, meta = dti
        heights.append(int(meta[1]))
        fn = _trace_stage(machine, c, tuple(tuple(x.shape) for x in inputs),
                          meta, mk)
        return fn(*[_upload(x, dev) for x in inputs],
                  label=chip_span("main trace", ci))

    with stage("generate main traces"):
        main_traces = [one_trace(ci, c) for ci, c in enumerate(chips)]
    if mk is None:
        heights = [int(t.shape[0]) for t in main_traces]
    main_shapes = [(h, int(t.shape[1])) for h, t in zip(heights,
                                                         main_traces)]
    log_degrees = [_log2(h) for h in heights]

    def tree_of(committed, shapes, name):
        """The tree of the committed matrices (global shapes), built
        inside the span "merkle: <name>" (all but its root's level)."""
        label = f"merkle: {name}"
        if mk is None:
            root, levels = _build_levels_jit(committed, hasher, label)
            return DeviceTree(committed, root, levels)
        root, levels = _build_levels_mesh(committed, shapes, hasher, label,
                                          mk)
        return DeviceTree(committed, root, levels, [h for h, _w in shapes],
                          mk)

    def commit(mats, shapes, name, dshifts=None):
        dshifts = dshifts or [1] * len(mats)
        outs = [(_lde_stage(_shape(m), d, log_blowup, shift) if mk is None
                 else _mesh_lde_stage(s, d, log_blowup, shift, mk))(m)
                for m, s, d in zip(mats, shapes, dshifts)]
        tree = tree_of([o[2] for o in outs],
                       [(h << log_blowup, w) for h, w in shapes], name)
        return tree, [o[0] for o in outs], [o[1] for o in outs]

    def whole(x, h):
        """A mesh prove's array of h rows, whole (the debug checks)."""
        return _gather_rows(x) if _sharded(h, mk) else x

    # -- transcript ----------------------------------------------------------
    with stage("commit to preprocessed traces"):
        if prep_list:
            prep_tree, prep_coeffs, prep_ldes = commit(
                prep_list, prep_shapes, "preprocessed")
            prep_root = prep_tree.root
        else:
            prep_tree, prep_coeffs, prep_ldes = None, [], []
            prep_root = np.zeros(8, dtype=np.uint32)
    with span("prove: transcript"):
        challenger.observe_digest(prep_root)

    with stage("commit to main traces"):
        main_tree, main_coeffs, main_ldes = commit(main_traces, main_shapes,
                                                   "main")
    with span("prove: transcript"):
        challenger.observe_digest(main_tree.root)
        perm_challenges = [challenger.sample_ext() for _ in range(3)]
        ch_arr = _upload(np.array(perm_challenges, dtype=np.uint32), dev)

    def perm_one(ci, c, t):
        w, ld = main_shapes[ci][1], log_degrees[ci]
        if ci not in prep_indices:
            return _perm_stage(machine, c, ld, w, mk=mk)(t, ch_arr)
        if mk is None:
            prep = prep_list[prep_indices[ci]]
        else:  # zero-padded to the trace's rows before it is sharded
            prep = _upload(_host_block(_padded_host(
                prep_host[prep_indices[ci]], 1 << ld), mk), dev)
        return _perm_stage(machine, c, ld, w, (1 << ld, int(prep.shape[1]))
                           if mk is not None else _shape(prep),
                           mk)(t, prep, ch_arr)

    with stage("generate permutation traces"):
        perm_outs = [perm_one(ci, c, t)
                     for ci, (c, t) in enumerate(zip(chips, main_traces))]
    perm_flat = [o[0] for o in perm_outs]
    perm_shapes = [(h, int(f.shape[1])) for h, f in zip(heights, perm_flat)]
    with stage("commit to permutation traces"):
        perm_tree, perm_coeffs, perm_ldes = commit(perm_flat, perm_shapes,
                                                   "permutation")
    with span("prove: transcript"):
        challenger.observe_digest(perm_tree.root)
        cs_host = to_numpy(_stack_canon_stage(len(chips), mk)(
            tuple(o[1] for o in perm_outs)))
        cumulative_sums = _to_ext_tuples(cs_host)
        alpha = challenger.sample_ext()
        alpha_arr = _upload(np.array(alpha, dtype=np.uint32), dev)

    if config.debug_checks:
        with stage("check constraints"):
            for h, c, t, flat, cs in zip(heights, chips, main_traces,
                                         perm_flat, cumulative_sums):
                t, flat = whole(t, h), whole(flat, h)
                perm_trace = bb.to_monty(flat).reshape(
                    flat.shape[0], flat.shape[1] // 5, 5)
                check_constraints(machine, c, t, perm_trace,
                                  perm_challenges, cs)
            check_cumulative_sums(cumulative_sums)

    # -- quotient ------------------------------------------------------------
    def quotient_one(ci, chip):
        prep_lde = prep_ldes[prep_indices[ci]] if ci in prep_indices else None
        ps = prep_shapes[prep_indices[ci]] if ci in prep_indices else None
        shapes_q = ((heights[ci] << log_blowup, main_shapes[ci][1]),
                    (heights[ci] << log_blowup, perm_shapes[ci][1]),
                    (ps[0] << log_blowup, ps[1]) if ps else None)
        fn = _quotient_stage(machine, chip, log_degrees[ci], qds[ci],
                             shapes_q, shift, log_blowup, mk)
        return fn(prep_lde, main_ldes[ci], perm_ldes[ci], ch_arr, alpha_arr,
                  _upload(cs_host[ci], dev), label=chip_span("quotient", ci))

    with stage("compute quotient polynomial"):
        quotient_mats = [quotient_one(ci, c) for ci, c in enumerate(chips)]
    quot_shapes = [(h, (1 << qd) * 5) for h, qd in zip(heights, qds)]
    with stage("commit to quotient chunks"):
        quotient_tree, quotient_coeffs, quotient_ldes = commit(
            quotient_mats, quot_shapes, "quotient chunks",
            [bb.h_exp(shift, 1 << qd) for qd in qds])
    with span("prove: transcript"):
        challenger.observe_digest(quotient_tree.root)
        zeta = challenger.sample_ext()
        zeta_m = extf.ext_const(zeta, dev)

    # -- openings ------------------------------------------------------------
    rounds = []  # (tree, coefficients, LDEs, point kinds, global shapes)
    if prep_tree is not None:
        rounds.append((prep_tree, prep_coeffs, prep_ldes,
                       [("pair", log_degrees[ci]) for ci in prep_indices],
                       prep_shapes))
    rounds.append((main_tree, main_coeffs, main_ldes,
                   [("pair", ld) for ld in log_degrees], main_shapes))
    rounds.append((perm_tree, perm_coeffs, perm_ldes,
                   [("pair", ld) for ld in log_degrees], perm_shapes))
    rounds.append((quotient_tree, quotient_coeffs, quotient_ldes,
                   [("pow", qd) for qd in qds], quot_shapes))
    all_coeffs = [c for r in rounds for c in r[1]]
    all_ldes = [x for r in rounds for x in r[2]]
    all_mats = [(s, kind) for r in rounds for s, kind in zip(r[4], r[3])]
    direct, groups, offs = _opening_layout(all_mats, log_blowup, fri_config)

    def direct_poly(mi):
        """A direct-opened matrix's coefficients, natural, on the host."""
        (h, w), c = all_mats[mi][0], all_coeffs[mi]
        if not _sharded(h, mk):
            return to_numpy(bb.from_monty(c))
        c = to_numpy(bb.from_monty(_gather_stage((h, w), mk)(c)))
        return c[nttm.bitrev_indices(_log2(h))]

    with span("prove: direct polys"):
        direct_polys = [direct_poly(mi) for mi in sorted(direct)]
    group_items = list(groups.items())

    def open_direct(mi):
        """A direct-opened matrix at its kind's points, on the host."""
        coeffs = direct_polys[sorted(direct).index(mi)].astype(np.uint64)
        tag, param = all_mats[mi][1]
        if tag == "pair":
            points = [zeta, extf.e_scale(zeta, bb.two_adic_generator(param))]
        else:
            points = [extf.e_exp(zeta, 1 << param)]
        out = []
        for z in points:
            zp = np.asarray(extf.e_powers(z, coeffs.shape[0]),
                            dtype=np.uint64)
            vals = np.stack([((coeffs * zp[:, d:d + 1]) % bb.P).sum(axis=0)
                             % bb.P for d in range(5)], axis=1)
            out.append(_to_ext_tuples(vals))
        return out

    with stage("open at zeta"):
        group_vals = [
            _openings_stage(tuple(all_mats[mi][0] for mi in members), kind,
                            mk)(
                tuple(all_coeffs[mi] for mi in members), zeta_m)
            for (_lh, kind), members in group_items]
        fetched = iter(_fetch_all([v for vals in group_vals for v in vals]))
        opened = [None] * len(all_mats)
        for ((_lh, _kind), members), vals in zip(group_items, group_vals):
            host_points = [_from_monty_host(next(fetched)) for _ in vals]
            off = 0
            for mi in members:
                w = all_mats[mi][0][1]
                opened[mi] = [_to_ext_tuples(hp[off:off + w])
                              for hp in host_points]
                off += w
        with span("prove: open direct"):
            for mi in sorted(direct):
                opened[mi] = open_direct(mi)
    with span("prove: observe openings"):
        for mat_vals in opened:
            for point_vals in mat_vals:
                for val in point_vals:
                    challenger.observe_ext(val)
        observe_direct_polys(challenger, direct_polys)
        alpha_fri_m = extf.ext_const(challenger.sample_ext(), dev)

    reduced = {}
    with stage("reduce openings"):
        for gi, ((log_h, kind), members) in enumerate(group_items):
            log_lde = log_h + log_blowup
            contrib = _reduced_stage(
                tuple(all_mats[mi][0] for mi in members), kind, log_lde,
                _col_offs(all_mats, offs, members), shift, mk)(tuple(all_ldes[mi] for mi in members), group_vals[gi],
                    zeta_m, alpha_fri_m)
            if log_lde in reduced:
                contrib = _add_stage((1 << log_lde, 5), mk)(reduced[log_lde],
                                                            contrib)
            reduced[log_lde] = contrib

    # -- FRI: the ladder on the card, its roots fetched once, then the host
    # challenger replays the layers' observes and samples.  In a mesh prove
    # a layer is this rank's block while the ranks divide its half: the
    # layer of D rows is gathered whole -----------------------------------
    log_max = max(reduced)
    log_stop = frim.fri_log_stop(fri_config, log_max, min(reduced))
    current = reduced[log_max]
    layer_trees, root_devs = [], []
    with stage("FRI commit phase"):
        k0 = len(challenger.input_buffer)
        dev_state = _upload(np.array(challenger.state, dtype=np.uint32),
                            dev)
        pending = _upload(np.array(challenger.input_buffer,
                                   dtype=np.uint32), dev)
        for layer, log_m in enumerate(range(log_max, log_stop, -1)):
            if (_sharded(1 << log_m, mk)
                    and not _sharded(1 << (log_m - 1), mk)):
                current = _gather_stage((1 << log_m, 5), mk)(current)
            pair_mat = _fri_pair_mat(log_m, mk)(current)
            layer_trees.append(tree_of([pair_mat], [(1 << (log_m - 1), 10)],
                                       "FRI layer"))
            root = layer_trees[-1]._root
            root_devs.append(root)
            kk = k0 if layer == 0 else 0
            chal = _ladder_challenge_stage(kk, poseidon.PARAM_SET, mk)
            dev_state, beta_m = (chal(dev_state, pending, root) if kk
                                 else chal(dev_state, root))
            inject = (log_m - 1) in reduced
            fold = _fri_fold(log_m, frim.layer_shift(shift, layer), inject,
                             mk)
            current = (fold(current, beta_m, reduced[log_m - 1]) if inject
                       else fold(current, beta_m))
        if _sharded(1 << log_stop, mk):
            current = _gather_stage((1 << log_stop, 5), mk)(current)
        commits = _fetch_all(root_devs)
        for r in commits:
            challenger.observe_digest(r)
            challenger.sample_ext()
    with span("prove: final poly"):
        final_poly = frim.extract_final_poly(current, fri_config, log_max,
                                             log_stop, shift, challenger)
    with stage("PoW grind"):
        pow_witness = frim.grind_device(challenger,
                                        fri_config.proof_of_work_bits, dev)
    with span("prove: query indices"):
        qidx = np.array([challenger.sample_bits(log_max)
                         for _ in range(fri_config.num_queries)],
                        dtype=np.int64)

    # -- query openings: a gather stage per tree, one fetch for all ----------
    with stage("query openings"):
        flat, cur = [], qidx
        for tree in layer_trees:
            cur = cur >> 1
            rows, paths = tree.open_batch(cur)
            flat += [rows[0], paths]
        for tree, *_rest in rounds:
            rows, paths = tree.open_batch(qidx >> (log_max - tree.log_max))
            flat += list(rows) + [paths]
        fetched = iter(_fetch_all(flat))
        layer_opens = [(next(fetched), next(fetched)) for _ in layer_trees]
        round_opens = [([next(fetched) for _ in r[1]], next(fetched))
                       for r in rounds]
    with span("prove: assemble proof"):
        fri_queries = [
            frim.FriQueryProof(commit_phase_openings=[
                frim.CommitPhaseOpening(pair_row=rows[qi],
                                        path=paths[qi])
                for rows, paths in layer_opens])
            for qi in range(len(qidx))]
        opening_proof = PcsProof(
            fri=frim.FriProof(commit_phase_commits=commits,
                              final_poly=final_poly, pow_witness=pow_witness,
                              query_proofs=fri_queries),
            query_proofs=[
                PcsQueryProof(
                    input_openings=[
                        BatchOpening(opened_rows=[r[qi] for r in rows],
                                     path=paths[qi])
                        for rows, paths in round_opens],
                    fri_query=fri_queries[qi])
                for qi in range(len(qidx))],
            direct_polys=direct_polys)

        # -- opened values per chip ------------------------------------------
        n_prep, n = len(prep_list), len(chips)
        chip_proofs = []
        for ci in range(n):
            pv = (opened[prep_indices[ci]] if ci in prep_indices
                  else [[], []])
            mv, ev = opened[n_prep + ci], opened[n_prep + n + ci]
            chip_proofs.append(ChipProof(
                log_degree=log_degrees[ci],
                opened_values=OpenedValues(
                    preprocessed_local=pv[0], preprocessed_next=pv[1],
                    trace_local=mv[0], trace_next=mv[1],
                    permutation_local=ev[0], permutation_next=ev[1],
                    quotient_chunks=opened[n_prep + 2 * n + ci][0]),
                cumulative_sum=cumulative_sums[ci]))
        return MachineProof(
            commitments=Commitments(preprocessed=prep_root,
                                    main_trace=main_tree.root,
                                    perm_trace=perm_tree.root,
                                    quotient_chunks=quotient_tree.root),
            opening_proof=opening_proof, chip_proofs=chip_proofs)
