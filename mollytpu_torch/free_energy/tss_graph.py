"""TSS window graphs: overlapping window tilings over expanded-ensemble
rungs (counterpart of mollytpu/free_energy/tss_graph.py, copied: pure
Python).

A ladder or grid of thermodynamic states ("rungs") is covered by
overlapping local windows; every rung belongs to exactly two windows (or
one for a single-window graph), adjacent windows share rungs, and swaps
between the two containing windows let a replica walk the whole graph
while estimators only ever see their local window. The graph is built once
and is static for the whole run.

All indices are 0-based.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TSSWindow:
    """A set of rung (state) indices plus the superset of rungs whose
    reduced potentials are evaluated for this window (windows.jl:1-47)."""

    index: int
    state_indices: Tuple[int, ...]
    evaluation_state_indices: Tuple[int, ...]

    def __init__(self, index, state_indices, evaluation_state_indices=None,
                 check_contiguous=True):
        if index < 0:
            raise ValueError("window index must be non-negative")
        state_indices = [int(s) for s in state_indices]
        if not state_indices:
            raise ValueError("state_indices must be non-empty")
        if any(s < 0 for s in state_indices):
            raise ValueError("state_indices entries must be non-negative")
        if len(set(state_indices)) != len(state_indices):
            raise ValueError("state_indices entries must be unique")
        if check_contiguous:
            state_indices = sorted(state_indices)
            if len(state_indices) > 1 and any(
                    b - a != 1 for a, b in zip(state_indices,
                                               state_indices[1:])):
                raise ValueError(
                    "state_indices must be contiguous for linear TSS windows;"
                    " use check_contiguous=False for non-linear windows")
        if evaluation_state_indices is None:
            ev = list(state_indices)
        else:
            ev = list(dict.fromkeys(
                state_indices + [int(s) for s in evaluation_state_indices]))
        if any(s < 0 for s in ev):
            raise ValueError("evaluation_state_indices must be non-negative")
        object.__setattr__(self, "index", int(index))
        object.__setattr__(self, "state_indices", tuple(state_indices))
        object.__setattr__(self, "evaluation_state_indices", tuple(ev))

    def __contains__(self, state):
        return int(state) in self.state_indices


@dataclasses.dataclass(frozen=True)
class TSSGraph:
    """Window graph over K rungs (windows.jl TSSGraph :66): windows, rung to
    containing-windows map, per-rung lambda-neighbor triples (reverse,
    forward, n_real_neighbors) per dimension, and rung volumes (0.5 per
    non-periodic boundary face) used by the CovDet adaptive gamma."""

    n_states: int
    windows: Tuple[TSSWindow, ...]
    state_to_windows: Tuple[Tuple[int, ...], ...]
    rung_neighbors: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    rung_volumes: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class _Edge:
    nodes: object
    shape: Tuple[int, ...]
    window_size: Tuple[int, ...]
    periodic: Tuple[bool, ...]
    primary_window_tiling_only: bool


@dataclasses.dataclass(frozen=True)
class _PartialMembership:
    dimension: int
    side: int      # 0 = low face, 1 = high face


@dataclasses.dataclass(frozen=True)
class _DimWindow:
    start: int
    size: int
    partials: Tuple[_PartialMembership, ...]


@dataclasses.dataclass(frozen=True)
class _WindowSpec:
    sort_key: Tuple[int, ...]
    state_indices: Tuple[int, ...]
    partial_signature: Optional[Tuple[str, ...]]


class TSSGraphBuilder:
    """Accumulates edges; build_tss_graph() makes the immutable TSSGraph
    (windows.jl:95-101). Multi-edge graphs join named corner nodes so
    boundary partial windows merge across edges."""

    def __init__(self):
        self.edges: List[_Edge] = []


def _as_tuple(value, n_dims, name, cast):
    if isinstance(value, (tuple, list)):
        vals = [cast(v) for v in value]
    else:
        vals = [cast(value)] * n_dims
    if len(vals) != n_dims:
        raise ValueError(f"{name} must have length {n_dims}")
    return tuple(vals)


def _node_name(nodes, corner):
    cur = nodes
    for c in corner:
        cur = cur[c]
    return str(cur)


def anonymous_tss_nodes(n_dims):
    """Nested 2^n structure of '_' corner names (windows.jl:393)."""
    if n_dims == 0:
        return "_"
    return [anonymous_tss_nodes(n_dims - 1) for _ in range(2)]


def add_tss_edge(builder, nodes, shape, window_size, periodic=False,
                 primary_window_tiling_only=False):
    """Add one edge (a regular rung grid) to the builder
    (windows.jl add_tss_edge! :358-391)."""
    shape = tuple(int(s) for s in (
        shape if isinstance(shape, (tuple, list)) else (shape,)))
    n_dims = len(shape)
    if n_dims == 0 or any(s <= 0 for s in shape):
        raise ValueError("TSS edge shape entries must be positive")
    window_size = _as_tuple(window_size, n_dims, "window_size", int)
    if any(w <= 0 for w in window_size):
        raise ValueError("TSS window_size entries must be positive")
    periodic = _as_tuple(periodic, n_dims, "periodic", bool)
    # corner-name uniqueness within the edge
    seen = {}
    for corner in itertools.product(range(2), repeat=n_dims):
        name = _node_name(nodes, corner)
        if name == "_":
            continue
        if name in seen:
            raise ValueError(f"TSS edge node name {name} repeated in one edge")
        seen[name] = True
    builder.edges.append(_Edge(nodes, shape, window_size, periodic,
                               bool(primary_window_tiling_only)))
    return builder


def tss_grid_graph(shape, window_size, periodic=False):
    """Regular TSS grid graph: one anonymous edge with regular + overlapping
    window tilings (windows.jl tss_grid_graph :396-414)."""
    shape_t = tuple(int(s) for s in (
        shape if isinstance(shape, (tuple, list)) else (shape,)))
    builder = TSSGraphBuilder()
    add_tss_edge(builder, anonymous_tss_nodes(len(shape_t)), shape_t,
                 window_size=window_size, periodic=periodic)
    return build_tss_graph(builder)


def single_window_tss_graph(n_states):
    """One window containing every rung (windows.jl:305-318)."""
    if n_states < 1:
        raise ValueError("number of states must be >= 1")
    window = TSSWindow(0, range(n_states))
    return TSSGraph(
        n_states=n_states,
        windows=(window,),
        state_to_windows=tuple((0,) for _ in range(n_states)),
        rung_neighbors=tuple(() for _ in range(n_states)),
        rung_volumes=tuple(1.0 for _ in range(n_states)),
    )


# -- edge geometry -----------------------------------------------------------

def _edge_offsets(edges):
    offsets, nxt = [], 0
    for e in edges:
        offsets.append(nxt)
        nxt += math.prod(e.shape)
    return offsets


def _rung_index(edge, offset, coord):
    """Column-major linearization matching Julia's LinearIndices."""
    idx, stride = 0, 1
    for c, n in zip(coord, edge.shape):
        idx += c * stride
        stride *= n
    return offset + idx


def _edge_coordinates(edge):
    # column-major iteration order (first dim fastest), as CartesianIndices
    ranges = [range(n) for n in edge.shape]
    for rev in itertools.product(*reversed(ranges)):
        yield tuple(reversed(rev))


def _rung_volume(edge, coord):
    n_faces = sum(1 for d, c in enumerate(coord)
                  if not edge.periodic[d] and (c == 0 or
                                               c == edge.shape[d] - 1))
    return 0.5 ** n_faces


def _neighbor_coord(edge, coord, dim, step):
    n = edge.shape[dim]
    if n == 1:
        return coord
    trial = coord[dim] + step
    out = list(coord)
    if edge.periodic[dim]:
        out[dim] = trial % n
    elif 0 <= trial < n:
        out[dim] = trial
    return tuple(out)


def _rung_neighbors(edge, offset, coord):
    out = []
    self_idx = _rung_index(edge, offset, coord)
    for dim in range(len(coord)):
        rev = _rung_index(edge, offset, _neighbor_coord(edge, coord, dim, -1))
        fwd = _rung_index(edge, offset, _neighbor_coord(edge, coord, dim, 1))
        out.append((rev, fwd, (rev != self_idx) + (fwd != self_idx)))
    return tuple(out)


# -- window tilings ----------------------------------------------------------

def _dim_windows(n_states, window_size, periodic, dim, overlapping):
    """Per-dimension regular tiling + half-offset overlapping tiling with
    boundary partial windows (windows.jl tss_dim_windows :481-524)."""
    if n_states < window_size:
        raise ValueError(f"TSS window_size[{dim}] must not exceed "
                         f"shape[{dim}]")
    if n_states % window_size != 0:
        raise ValueError(f"TSS shape[{dim}] must be divisible by "
                         f"window_size[{dim}]")
    regular = [_DimWindow(start, window_size, ())
               for start in range(0, n_states, window_size)]
    if not overlapping:
        return regular, []
    if window_size % 2 != 0:
        raise ValueError(f"TSS window_size[{dim}] must be even for "
                         "overlapping windows")
    half = window_size // 2
    overlap = []
    if periodic:
        for start in range(half, n_states, window_size):
            overlap.append(_DimWindow(start, window_size, ()))
    else:
        for start in range(half, n_states - window_size + 1, window_size):
            overlap.append(_DimWindow(start, window_size, ()))
        overlap.append(_DimWindow(0, half,
                                  (_PartialMembership(dim, 0),)))
        overlap.append(_DimWindow(n_states - half, half,
                                  (_PartialMembership(dim, 1),)))
    return regular, overlap


def _dim_state_values(dim_window, n_states, periodic):
    return [(dim_window.start + o) % n_states if periodic
            else dim_window.start + o
            for o in range(dim_window.size)]


def _partial_signature(edge, partials):
    """Corner-node names on the fixed boundary faces, used to merge partial
    windows of adjacent edges sharing a node (windows.jl:537-552)."""
    if not partials:
        return None
    fixed = {p.dimension: p.side for p in partials}
    names = []
    for corner in itertools.product(range(2), repeat=len(edge.shape)):
        if all(fixed.get(d, corner[d]) == corner[d]
               for d in range(len(corner))):
            name = _node_name(edge.nodes, corner)
            if name != "_":
                names.append(name)
    if not names:
        return None
    return tuple(sorted(set(names)))


def _window_spec(edge, offset, windows_by_dim):
    values_by_dim = [
        _dim_state_values(windows_by_dim[d], edge.shape[d], edge.periodic[d])
        for d in range(len(edge.shape))]
    states = []
    # column-major product (first dim fastest) to match the reference order
    for combo_rev in itertools.product(*reversed(values_by_dim)):
        states.append(_rung_index(edge, offset, tuple(reversed(combo_rev))))
    partials = tuple(p for w in windows_by_dim for p in w.partials)
    return _WindowSpec(
        sort_key=tuple(w.start for w in windows_by_dim),
        state_indices=tuple(states),
        partial_signature=_partial_signature(edge, partials))


def _edge_window_specs(edge, offset):
    regular_by_dim, overlap_by_dim = [], []
    for dim in range(len(edge.shape)):
        reg, ov = _dim_windows(edge.shape[dim], edge.window_size[dim],
                               edge.periodic[dim], dim,
                               not edge.primary_window_tiling_only)
        regular_by_dim.append(reg)
        overlap_by_dim.append(ov)
    specs = []
    for combo_rev in itertools.product(*reversed(regular_by_dim)):
        specs.append(_window_spec(edge, offset, tuple(reversed(combo_rev))))
    if not edge.primary_window_tiling_only:
        for combo_rev in itertools.product(*reversed(overlap_by_dim)):
            specs.append(_window_spec(edge, offset, tuple(reversed(combo_rev))))
    return specs


def _merge_window_specs(specs):
    """Merge boundary partial windows sharing a node signature across edges
    (windows.jl merge_tss_window_specs :584-618)."""
    full, unmerged = [], []
    groups = {}
    for spec in specs:
        if spec.partial_signature is None:
            full.append(spec)
        else:
            groups.setdefault(spec.partial_signature, []).append(spec)
    merged = list(full)
    for group in groups.values():
        if len(group) == 1:
            unmerged.append(group[0])
            continue
        states = []
        for spec in group:
            states.extend(spec.state_indices)
        states = list(dict.fromkeys(states))
        sort_key = min(tuple(s.sort_key) for s in group)
        merged.append(_WindowSpec(sort_key, tuple(states), None))
    merged.extend(unmerged)
    merged.sort(key=lambda s: (s.sort_key, len(s.state_indices),
                               s.state_indices))
    return merged


def _evaluation_states(state_indices, rung_neighbors):
    ev = list(state_indices)
    for s in state_indices:
        for rev, fwd, _ in rung_neighbors[s]:
            ev.append(rev)
            ev.append(fwd)
    return tuple(dict.fromkeys(ev))


# -- validation & assembly ---------------------------------------------------

def build_state_to_windows(windows, n_states):
    out = [[] for _ in range(n_states)]
    for w in windows:
        for s in w.state_indices:
            out[s].append(w.index)
    return tuple(tuple(x) for x in out)


def _overlap_adjacency(windows):
    adj = [[] for _ in windows]
    for i in range(len(windows)):
        si = set(windows[i].state_indices)
        for j in range(i + 1, len(windows)):
            if si & set(windows[j].state_indices):
                adj[i].append(j)
                adj[j].append(i)
    return adj


def check_window_graph_connected(windows):
    adj = _overlap_adjacency(windows)
    seen = [False] * len(windows)
    stack = [0]
    seen[0] = True
    while stack:
        w = stack.pop()
        for n in adj[w]:
            if not seen[n]:
                seen[n] = True
                stack.append(n)
    if not all(seen):
        raise ValueError("TSS window overlap graph must be connected")
    return adj


def validate_window_coverage(windows, state_to_windows, n_states,
                             required_coverage=None):
    if required_coverage is None:
        required_coverage = 1 if len(windows) == 1 else 2
    for s in range(n_states):
        n_cover = len(state_to_windows[s])
        if n_cover != required_coverage:
            raise ValueError(
                f"state {s} must be covered by exactly {required_coverage} "
                f"window(s); got {n_cover}")
    check_window_graph_connected(windows)


def build_tss_graph(builder):
    """Assemble the TSSGraph from all builder edges
    (windows.jl build_tss_graph :655-711)."""
    if not builder.edges:
        raise ValueError("TSSGraphBuilder must contain at least one edge")
    offsets = _edge_offsets(builder.edges)
    n_total = sum(math.prod(e.shape) for e in builder.edges)
    rung_neighbors = [() for _ in range(n_total)]
    rung_volumes = [0.0] * n_total
    specs = []
    for edge, offset in zip(builder.edges, offsets):
        for coord in _edge_coordinates(edge):
            s = _rung_index(edge, offset, coord)
            rung_neighbors[s] = _rung_neighbors(edge, offset, coord)
            rung_volumes[s] = _rung_volume(edge, coord)
        specs.extend(_edge_window_specs(edge, offset))
    merged = _merge_window_specs(specs)
    windows = tuple(
        TSSWindow(i, spec.state_indices,
                  evaluation_state_indices=_evaluation_states(
                      spec.state_indices, rung_neighbors),
                  check_contiguous=False)
        for i, spec in enumerate(merged))
    state_to_windows = build_state_to_windows(windows, n_total)
    validate_window_coverage(windows, state_to_windows, n_total,
                             required_coverage=2)
    return TSSGraph(n_total, windows, state_to_windows,
                    tuple(rung_neighbors), tuple(rung_volumes))


def tss_swap_window(graph, active_window, state_index):
    """The OTHER window containing `state_index`
    (windows.jl tss_swap_window :713-729)."""
    if not 0 <= state_index < graph.n_states:
        raise ValueError(f"state {state_index} out of TSS graph bounds")
    wins = graph.state_to_windows[state_index]
    if len(wins) != 2:
        raise ValueError(
            f"state {state_index} is not covered by exactly two windows")
    if active_window == wins[0]:
        return wins[1]
    if active_window == wins[1]:
        return wins[0]
    raise ValueError(f"active window {active_window} does not contain "
                     f"state {state_index}")
