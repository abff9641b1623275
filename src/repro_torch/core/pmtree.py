"""PM-tree construction (paper §4.1) — host-side, numpy.

The PM-tree [Skopal et al., DASFAA'05] = M-tree + `s` global pivots whose
hyper-ring intervals (HR) tighten every node region.  We provide two
builders that produce the same flattened structure:

* :func:`build_bulk` — top-down M-way ball partitioning (production
  path; O(n log n) distance computations, vectorized numpy).
* :func:`build_insert` — paper-faithful one-by-one insertion with node
  splits and the two Promote policies of §6.3 (``m_RAD`` minimizing the
  sum of covering radii, ``RANDOM``).  Used by the γ / Promote-method
  experiments (Figs. 7, 14-16, Table 5).

The flattened form (:class:`FlatPMTree`) stores nodes in BFS order so
that (a) the children of any node are contiguous, (b) each level is a
contiguous slice, and (c) leaf point ranges partition a permutation of
the dataset.  That layout is what the level-synchronous query on the
card in ``pmtree_query.py`` consumes.

A copy of ``repro.core.pmtree``: numpy with numpy's ``default_rng``, so
the port's trees are identical to the reference's on the same projected
array.

Node region / pruning condition (Eq. 5): node ``e`` may contain a point
within radius ``r_q`` of query ``q`` only if

    ||q, e.RO|| <= e.r + r_q
    AND  for every pivot p_i:  ||q,p_i|| - r_q <= e.HR[i].max
    AND  for every pivot p_i:  ||q,p_i|| + r_q >= e.HR[i].min
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FlatPMTree", "build_bulk", "build_insert", "select_pivots"]


# --------------------------------------------------------------------------
# flattened tree
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FlatPMTree:
    """Array-of-structs PM-tree, BFS node order.

    All arrays are numpy on the host; the device query path puts them on
    the card once (``pmtree_query.DeviceTree``).  ``n_points`` projected
    points live in ``points`` (permuted by ``perm``:
    ``points[i] == original[perm[i]]``).
    """

    # node arrays, length N (BFS order; node 0 is the root)
    centers: np.ndarray  # (N, m) routing objects o' in projected space
    radii: np.ndarray  # (N,) covering radius e.r
    parent_dist: np.ndarray  # (N,) e.PD = ||e.RO, parent.RO||
    hr_min: np.ndarray  # (N, s)
    hr_max: np.ndarray  # (N, s)
    parent: np.ndarray  # (N,) int32, -1 for root
    child_start: np.ndarray  # (N,) int32 — first child node id (BFS)
    child_count: np.ndarray  # (N,) int32 — 0 for leaves
    leaf_start: np.ndarray  # (N,) int32 — first point slot (leaves only)
    leaf_count: np.ndarray  # (N,) int32 — 0 for inner nodes
    level_offsets: np.ndarray  # (depth+1,) node-id boundaries per level
    # point arrays, length n
    points: np.ndarray  # (n, m) projected points, permuted
    perm: np.ndarray  # (n,) original index of slot i
    point_leaf: np.ndarray  # (n,) leaf node id owning slot i
    # pivots
    pivots: np.ndarray  # (s, m)

    @property
    def n_nodes(self) -> int:
        return self.centers.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_pivots(self) -> int:
        return self.pivots.shape[0]

    @property
    def depth(self) -> int:
        return len(self.level_offsets) - 1

    @property
    def is_leaf(self) -> np.ndarray:
        return self.child_count == 0

    def validate(self) -> None:
        """Structural invariants (used by tests & hypothesis properties)."""
        n, N = self.n_points, self.n_nodes
        assert self.perm.shape == (n,)
        assert sorted(self.perm.tolist()) == list(range(n)), "perm must be a permutation"
        leaves = np.where(self.is_leaf)[0]
        covered = np.zeros(n, dtype=bool)
        for e in leaves:
            s, c = int(self.leaf_start[e]), int(self.leaf_count[e])
            assert c > 0, "leaf with no points"
            assert not covered[s : s + c].any(), "leaf ranges overlap"
            covered[s : s + c] = True
            assert (self.point_leaf[s : s + c] == e).all()
            # covering radius + HR rings really cover the member points
            pts = self.points[s : s + c]
            dist = np.linalg.norm(pts - self.centers[e], axis=-1)
            assert (dist <= self.radii[e] + 1e-4).all(), "leaf radius violated"
            pd = np.linalg.norm(pts[:, None, :] - self.pivots[None], axis=-1)
            assert (pd >= self.hr_min[e] - 1e-4).all()
            assert (pd <= self.hr_max[e] + 1e-4).all()
        assert covered.all(), "points not fully covered by leaves"
        # every inner node covers its children (radius + rings nest)
        for e in range(N):
            cs, cc = int(self.child_start[e]), int(self.child_count[e])
            for ch in range(cs, cs + cc):
                assert self.parent[ch] == e
                d = np.linalg.norm(self.centers[ch] - self.centers[e])
                assert d + self.radii[ch] <= self.radii[e] + 1e-3, "child ball escapes parent"
                assert (self.hr_min[e] <= self.hr_min[ch] + 1e-4).all()
                assert (self.hr_max[e] >= self.hr_max[ch] - 1e-4).all()


# --------------------------------------------------------------------------
# pivot selection
# --------------------------------------------------------------------------


def select_pivots(points: np.ndarray, s: int, seed: int = 0) -> np.ndarray:
    """Incremental farthest-point pivot selection (§4.1 'Selecting Pivots').

    The paper selects pivots to minimize the PM-region volume; the
    standard practical surrogate is max-separated pivots, which makes
    the hyper-ring intervals narrow for random queries.
    """
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    s = min(s, n)
    first = int(rng.integers(n))
    chosen = [first]
    dmin = np.linalg.norm(points - points[first], axis=-1)
    for _ in range(s - 1):
        nxt = int(np.argmax(dmin))
        chosen.append(nxt)
        dmin = np.minimum(dmin, np.linalg.norm(points - points[nxt], axis=-1))
    return points[np.asarray(chosen)].copy()


# --------------------------------------------------------------------------
# bulk (top-down) build — production path
# --------------------------------------------------------------------------


def _kcenter_split(pts: np.ndarray, idx: np.ndarray, k: int, rng) -> list[np.ndarray]:
    """Split point set into <=k groups via farthest-point seeding +
    nearest-center assignment (generalized-hyperplane, k-way)."""
    n = idx.size
    k = min(k, n)
    seeds = [int(rng.integers(n))]
    dmin = np.linalg.norm(pts - pts[seeds[0]], axis=-1)
    for _ in range(k - 1):
        nxt = int(np.argmax(dmin))
        if dmin[nxt] == 0.0:
            break
        seeds.append(nxt)
        dmin = np.minimum(dmin, np.linalg.norm(pts - pts[nxt], axis=-1))
    centers = pts[seeds]
    assign = np.argmin(
        np.linalg.norm(pts[:, None, :] - centers[None], axis=-1), axis=1
    )
    groups = []
    for g in range(len(seeds)):
        sel = assign == g
        if sel.any():
            groups.append(idx[sel])
    return groups


def build_bulk(
    points_proj: np.ndarray,
    *,
    capacity: int = 16,
    fanout: int = 4,
    n_pivots: int = 5,
    seed: int = 0,
    pivots: np.ndarray | None = None,
) -> FlatPMTree:
    """Top-down recursive ball partitioning into a PM-tree.

    ``capacity`` bounds leaf size; ``fanout`` bounds inner-node arity.
    A LOW fanout (2-4) gives the graded radius spectrum the CP radius
    filter relies on (insertion-built M-trees split binary at overflow,
    so the paper's trees are likewise deep with graded radii); a higher
    fanout gives shallower trees for the level-synchronous NN query.
    """
    pts = np.asarray(points_proj, dtype=np.float32)
    n, m = pts.shape
    rng = np.random.default_rng(seed)
    if pivots is None:
        pivots = select_pivots(pts, n_pivots, seed=seed)
    pivots = np.asarray(pivots, dtype=np.float32)
    piv_dist = np.linalg.norm(pts[:, None, :] - pivots[None], axis=-1)  # (n, s)

    # recursive split to build a tree of index groups
    # each tree node: dict(children=[...]) or dict(points=idx)
    def split(idx: np.ndarray) -> dict:
        if idx.size <= capacity:
            return {"points": idx}
        groups = _kcenter_split(pts[idx], idx, fanout, rng)
        if len(groups) == 1:  # all duplicates — force balanced chunking
            chunks = [c for c in np.array_split(idx, fanout) if c.size]
            return {"children": [split(c) for c in chunks]}
        return {"children": [split(g) for g in groups]}

    root = split(np.arange(n))

    return _flatten(root, pts, pivots, piv_dist)


# --------------------------------------------------------------------------
# insertion build — paper-faithful (M-tree insert + Promote policies)
# --------------------------------------------------------------------------


class _Node:
    __slots__ = ("center", "radius", "children", "points", "parent")

    def __init__(self, center, radius=0.0, children=None, points=None):
        self.center = center
        self.radius = radius
        self.children = children  # list[_Node] | None
        self.points = points  # list[int] | None
        self.parent = None


def _mrad_promote(entries_c: np.ndarray, rad: np.ndarray, policy: str, rng):
    """Choose two promoted centers among entries. m_RAD scans all pairs for
    minimal sum of covering radii after hyperplane assignment (§6.3)."""
    k = entries_c.shape[0]
    if policy == "random":
        i, j = rng.choice(k, size=2, replace=False)
        return int(i), int(j)
    best, best_pair = np.inf, (0, 1)
    D = np.linalg.norm(entries_c[:, None, :] - entries_c[None], axis=-1)
    for i in range(k):
        for j in range(i + 1, k):
            to_i = D[:, i] <= D[:, j]
            r_i = (D[to_i, i] + rad[to_i]).max(initial=0.0)
            r_j = (D[~to_i, j] + rad[~to_i]).max(initial=0.0)
            if r_i + r_j < best:
                best, best_pair = r_i + r_j, (i, j)
    return best_pair


def build_insert(
    points_proj: np.ndarray,
    *,
    capacity: int = 16,
    n_pivots: int = 5,
    promote: str = "m_RAD",
    seed: int = 0,
    pivots: np.ndarray | None = None,
) -> FlatPMTree:
    """One-by-one M-tree insertion with overflow splits (paper-faithful)."""
    assert promote in ("m_RAD", "random", "RANDOM")
    policy = "random" if promote.lower() == "random" else "m_RAD"
    pts = np.asarray(points_proj, dtype=np.float32)
    n, m = pts.shape
    rng = np.random.default_rng(seed)
    if pivots is None:
        pivots = select_pivots(pts, n_pivots, seed=seed)
    pivots = np.asarray(pivots, dtype=np.float32)

    root = _Node(center=pts[0].copy(), radius=0.0, points=[0])

    def choose_leaf(node: _Node, p: np.ndarray) -> _Node:
        while node.points is None:
            cents = np.stack([c.center for c in node.children])
            d = np.linalg.norm(cents - p, axis=-1)
            rads = np.array([c.radius for c in node.children])
            inc = np.maximum(d - rads, 0.0)  # radius increase if adopted
            j = int(np.lexsort((d, inc))[0])  # min increase, tie-break dist
            node = node.children[j]
        return node

    def update_radii_up(leaf: _Node, p: np.ndarray):
        node = leaf
        while node is not None:
            node.radius = max(node.radius, float(np.linalg.norm(p - node.center)))
            node = node.parent

    def split(node: _Node):
        # gather entries (points or child nodes) of the overflowing node
        if node.points is not None:
            cents = pts[np.asarray(node.points)]
            rad = np.zeros(len(node.points))
        else:
            cents = np.stack([c.center for c in node.children])
            rad = np.array([c.radius for c in node.children])
        i, j = _mrad_promote(cents, rad, policy, rng)
        di = np.linalg.norm(cents - cents[i], axis=-1)
        dj = np.linalg.norm(cents - cents[j], axis=-1)
        to_i = di <= dj
        if to_i.all() or not to_i.any():  # degenerate duplicates
            to_i = np.arange(cents.shape[0]) % 2 == 0
            di = np.linalg.norm(cents - cents[i], axis=-1)
        a = _Node(center=cents[i].copy())
        b = _Node(center=cents[j].copy())
        for part, sel in ((a, to_i), (b, ~to_i)):
            if node.points is not None:
                part.points = [node.points[k] for k in np.where(sel)[0]]
                mem = pts[np.asarray(part.points)]
                part.radius = float(
                    np.linalg.norm(mem - part.center, axis=-1).max(initial=0.0)
                )
            else:
                part.children = [node.children[k] for k in np.where(sel)[0]]
                for ch in part.children:
                    ch.parent = part
                part.radius = float(
                    max(
                        np.linalg.norm(ch.center - part.center) + ch.radius
                        for ch in part.children
                    )
                )
        if node.parent is None:
            new_root = _Node(center=node.center.copy(), children=[a, b])
            a.parent = b.parent = new_root
            new_root.radius = float(
                max(
                    np.linalg.norm(ch.center - new_root.center) + ch.radius
                    for ch in new_root.children
                )
            )
            return new_root
        parent = node.parent
        parent.children.remove(node)
        parent.children.extend([a, b])
        a.parent = b.parent = parent
        # parent ball must still cover the two new child balls
        parent.radius = float(
            max(
                parent.radius,
                max(
                    np.linalg.norm(ch.center - parent.center) + ch.radius
                    for ch in (a, b)
                ),
            )
        )
        if len(parent.children) > capacity:
            return split(parent)
        return None

    for i in range(1, n):
        p = pts[i]
        leaf = choose_leaf(root, p)
        leaf.points.append(i)
        update_radii_up(leaf, p)
        if len(leaf.points) > capacity:
            new_root = split(leaf)
            if new_root is not None:
                root = new_root

    # convert _Node tree into the nested-dict shape _flatten expects
    def to_dict(node: _Node) -> dict:
        if node.points is not None:
            return {"points": np.asarray(node.points), "center": node.center}
        return {"children": [to_dict(c) for c in node.children], "center": node.center}

    piv_dist = np.linalg.norm(pts[:, None, :] - pivots[None], axis=-1)
    return _flatten(to_dict(root), pts, pivots, piv_dist)


# --------------------------------------------------------------------------
# flattening (shared)
# --------------------------------------------------------------------------


def _flatten(
    root: dict, pts: np.ndarray, pivots: np.ndarray, piv_dist: np.ndarray
) -> FlatPMTree:
    """BFS-number the nested dict tree and emit FlatPMTree arrays.

    Centers/radii/HR are recomputed exactly from subtree membership, so
    both builders share identical (tight) region semantics.
    """
    n, m = pts.shape
    s = pivots.shape[0]

    # BFS order
    levels: list[list[dict]] = [[root]]
    while True:
        nxt = [c for nd in levels[-1] if "children" in nd for c in nd["children"]]
        if not nxt:
            break
        levels.append(nxt)
    order: list[dict] = [nd for lvl in levels for nd in lvl]
    N = len(order)
    ids = {id(nd): i for i, nd in enumerate(order)}
    level_offsets = np.cumsum([0] + [len(lvl) for lvl in levels]).astype(np.int32)

    centers = np.zeros((N, m), np.float32)
    radii = np.zeros(N, np.float32)
    parent_dist = np.zeros(N, np.float32)
    hr_min = np.zeros((N, s), np.float32)
    hr_max = np.zeros((N, s), np.float32)
    parent = np.full(N, -1, np.int32)
    child_start = np.zeros(N, np.int32)
    child_count = np.zeros(N, np.int32)
    leaf_start = np.zeros(N, np.int32)
    leaf_count = np.zeros(N, np.int32)

    # assign point slots by DFS over leaves so each subtree is contiguous;
    # but BFS ids + per-leaf ranges are all the query path needs.
    perm_chunks: list[np.ndarray] = []
    cursor = 0

    # subtree membership (computed leaf-up)
    member: dict[int, np.ndarray] = {}

    # children links
    for nd in order:
        i = ids[id(nd)]
        if "children" in nd:
            child_ids = [ids[id(c)] for c in nd["children"]]
            child_start[i] = min(child_ids)
            child_count[i] = len(child_ids)
            for c in nd["children"]:
                parent[ids[id(c)]] = i

    # leaves first: assign ranges in BFS leaf order
    for nd in order:
        i = ids[id(nd)]
        if "children" not in nd:
            idx = np.asarray(nd["points"], dtype=np.int64)
            leaf_start[i] = cursor
            leaf_count[i] = idx.size
            cursor += idx.size
            perm_chunks.append(idx)
            member[i] = idx
    perm = np.concatenate(perm_chunks) if perm_chunks else np.zeros(0, np.int64)
    assert cursor == n

    # membership bottom-up
    for nd in reversed(order):
        i = ids[id(nd)]
        if "children" in nd:
            member[i] = np.concatenate([member[ids[id(c)]] for c in nd["children"]])

    # geometry: center = medoid-ish (use provided center if any, else mean's NN)
    for nd in order:
        i = ids[id(nd)]
        mem = member[i]
        sub = pts[mem]
        if "center" in nd and nd["center"] is not None:
            centers[i] = nd["center"]
        else:
            mu = sub.mean(axis=0)
            centers[i] = sub[np.argmin(np.linalg.norm(sub - mu, axis=-1))]
        radii[i] = float(np.linalg.norm(sub - centers[i], axis=-1).max(initial=0.0))
        pd = piv_dist[mem]
        hr_min[i] = pd.min(axis=0)
        hr_max[i] = pd.max(axis=0)
    # bottom-up (BFS ids are level-ordered, so reversed order = deepest first)
    for i in reversed(range(N)):
        if parent[i] >= 0:
            parent_dist[i] = float(np.linalg.norm(centers[i] - centers[parent[i]]))
            # M-tree invariant: parent ball covers child balls
            p = parent[i]
            radii[p] = max(radii[p], parent_dist[i] + radii[i])
    # nest HR intervals too (parent ring must contain child rings)
    for lvl in range(len(levels) - 1, 0, -1):
        lo, hi = level_offsets[lvl], level_offsets[lvl + 1]
        for i in range(lo, hi):
            p = parent[i]
            hr_min[p] = np.minimum(hr_min[p], hr_min[i])
            hr_max[p] = np.maximum(hr_max[p], hr_max[i])

    points_perm = pts[perm]
    point_leaf = np.zeros(n, np.int32)
    for i in range(N):
        if child_count[i] == 0:
            point_leaf[leaf_start[i] : leaf_start[i] + leaf_count[i]] = i

    return FlatPMTree(
        centers=centers,
        radii=radii,
        parent_dist=parent_dist,
        hr_min=hr_min,
        hr_max=hr_max,
        parent=parent,
        child_start=child_start,
        child_count=child_count,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        level_offsets=level_offsets,
        points=points_perm.astype(np.float32),
        perm=perm.astype(np.int64),
        point_leaf=point_leaf,
        pivots=pivots.astype(np.float32),
    )
