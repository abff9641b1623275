"""The sharded backends' process-group form, held to the emulated form and
to the JAX package's mesh path.

One ``torch.multiprocessing`` spawn a world size (2 and 4): gloo over a
file store under the test's tmp dir, every rank on the CPU.  Each rank
builds the same indexes over the default group and saves its answers;
the test process builds the emulated twins of the same shard count and
compares bit for bit (ids, distances, counters).  Every spawn is joined
with a hard 120-s limit that kills the ranks and fails the test.

The JAX side runs in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as the JAX
package's multidevice tests run it: the legacy ``sharded`` backend's
and ``sharded-flat``'s mesh paths at P = 2 and 4 (n = 203 ∤ P, so the
last shard holds padding, +inf rows in the legacy layout).  It hands
back its answers and its A and projected rows in an ``.npz``, from which
the port's indexes are built.
"""
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from conftest import make_clustered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
SPAWN_LIMIT_S = 120
ANN_CASES = ((1, 1), (7, 10))
N, D, K_CP = 203, 24, 6


def _queries(data, B, seed=3):
    r = np.random.default_rng(seed)
    return (data[r.choice(len(data), B, replace=False)]
            + r.normal(size=(B, data.shape[1])).astype(np.float32) * 0.05)


def _data():
    return make_clustered(N, D, seed=11)


def _pruning_data():
    return make_clustered(520, 16, n_clusters=20, spread=0.3, scale=8.0, seed=4)


_JAX = """
import numpy as np
from repro.index import IndexConfig, build_index
from repro.launch.mesh import make_data_mesh
data, q7, q1 = (np.load(IN)[k] for k in ("data", "q7", "q1"))
out = {}
for P in (2, 4):
    ji = build_index(data, IndexConfig(backend="sharded",
                                       options={"mesh": make_data_mesh(P)}))
    out[f"legacy{P}_a"] = np.asarray(ji.impl.family.a)
    out[f"legacy{P}_proj"] = np.asarray(ji.impl.proj_sh)[:len(data)]
    for B, q in ((1, q1), (7, q7)):
        k = 1 if B == 1 else 10
        r = ji.search(q, k)
        out[f"legacy{P}_ids{B}"], out[f"legacy{P}_d{B}"] = r.indices, r.distances
    c = ji.cp_search(6)
    out[f"legacy{P}_pairs"], out[f"legacy{P}_cpd"] = c.pairs, c.distances
    out[f"legacy{P}_verified"] = np.int64(c.stats.pairs_verified)
    sf = build_index(data, IndexConfig(backend="sharded-flat",
                                       options={"shards": P, "force": "ref"}))
    assert not sf.impl.emulated
    out["flat_a"] = np.asarray(sf.impl.family.a)
    out["flat_proj"] = np.asarray(sf.impl._proj_blocks).reshape(-1, sf.impl.m)[:len(data)]
    r = sf.search(q7, 10)
    out[f"flat{P}_ids"], out[f"flat{P}_d"] = r.indices, r.distances
    out[f"flat{P}_selected"] = np.int64(r.stats.candidates_selected)
    c = sf.cp_search(6)
    out[f"flat{P}_pairs"], out[f"flat{P}_cpd"] = c.pairs, c.distances
    out[f"flat{P}_cpstats"] = np.array([c.stats.pairs_verified, c.stats.tiles_pruned,
                                        c.stats.max_shard_pairs])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX package's mesh answers, from one 8-device subprocess."""
    d = tmp_path_factory.mktemp("jax_mesh")
    data = _data()
    np.savez(d / "in.npz", data=data, q7=_queries(data, 7), q1=_queries(data, 1))
    code = f"IN, OUT = {str(d / 'in.npz')!r}, {str(d / 'out.npz')!r}\n" + _JAX
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=SPAWN_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------


def _answers(prefix, res, out):
    out[prefix + "_ids"], out[prefix + "_d"] = res.indices, res.distances
    out[prefix + "_stats"] = np.array(list(res.stats.as_dict().values()), np.int64)


def _cp_answers(prefix, res, out):
    out[prefix + "_pairs"], out[prefix + "_d"] = res.pairs, res.distances
    out[prefix + "_stats"] = np.array(list(res.stats.as_dict().values()), np.int64)


def run_all(mesh_kw: dict, jax_mesh: dict, device: str = "cpu") -> dict:
    """Every answer the comparison needs, over the mesh ``mesh_kw`` names
    (a group mesh's ``{"mesh": mesh}``, or the emulated ``{"shards": P,
    "emulate": True}``): the same code in the ranks and in the test."""
    from repro_torch.index import (
        IndexConfig,
        ShardedBackend,
        ShardedFlatBackend,
        ShardedFlatPQBackend,
    )

    data, out = _data(), {}
    a, proj = jax_mesh["flat_a"], jax_mesh["flat_proj"]
    flat = ShardedFlatBackend.from_arrays(
        data, a, proj, IndexConfig(backend="sharded-flat", options=dict(mesh_kw)),
        device=device)
    for B, k in ANN_CASES:
        _answers(f"ann{B}_{k}", flat.search(_queries(data, B), k), out)
    _cp_answers("cp", flat.cp_search(K_CP), out)
    pq = ShardedFlatPQBackend(
        data, IndexConfig(backend="sharded-flat-pq", options=dict(mesh_kw)), device=device)
    _answers("pq", pq.search(_queries(data, 7), 10), out)
    out["pq_bytes"] = np.float64(pq.bytes_per_point())
    pruning = ShardedFlatBackend(_pruning_data(), IndexConfig(
        backend="sharded-flat", options=dict(mesh_kw)), device=device)
    _cp_answers("cp_pruned", pruning.cp_search(K_CP), out)
    P = flat.impl.P
    legacy = ShardedBackend.from_arrays(
        data, jax_mesh[f"legacy{P}_a"], jax_mesh[f"legacy{P}_proj"],
        IndexConfig(backend="sharded", options={"mesh": mesh_kw["mesh"]} if "mesh" in mesh_kw
                    else {"devices": P}), device=device)
    for B, k in ANN_CASES:
        _answers(f"legacy{B}", legacy.search(_queries(data, B), k), out)
    _cp_answers("legacy_cp", legacy.cp_search(K_CP), out)
    return out


def _rank(rank: int, world: int, store: str, jax_npz: str, out_dir: str) -> None:
    """One rank: gloo over the file store, the answers saved per rank."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        from repro_torch.launch import make_data_mesh

        mesh = make_data_mesh(device="cpu")
        out = run_all({"mesh": mesh}, dict(np.load(jax_npz)))
        # the collectives themselves, and what a group mesh refuses
        xs = torch.tensor([rank + 1, 10 * rank], dtype=torch.int32)
        out["psum"] = mesh.psum([xs]).numpy()
        out["pmax"] = mesh.pmax([xs.float()]).numpy()
        out["gather"] = torch.stack(mesh.all_gather([xs])).numpy()
        out["ring"] = mesh.ring([(xs, xs.float() * 0.5)])[0][1].numpy()
        refused = []
        for bad in (lambda: make_data_mesh(device="cuda"), lambda: make_data_mesh(world + 1,
                                                                                device="cpu")):
            try:
                bad()
                refused.append(0)
            except ValueError:
                refused.append(1)
        out["refused"] = np.array(refused)
        out["mesh"] = np.array([mesh.size, mesh.rank, int(mesh.emulated)])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def group(request, jax_mesh, tmp_path_factory):
    """(world, per-rank answers, the emulated twin's answers)."""
    world = request.param
    d = tmp_path_factory.mktemp(f"gloo{world}")
    np.savez(d / "jax.npz", **jax_mesh)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, str(d / "store"), str(d / "jax.npz"),
                                              str(d)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errs = "".join(f.read_text() for f in sorted(d.glob("rank*.err")))
    assert not hung, f"world {world}: {len(hung)} ranks still running after {SPAWN_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), errs[-4000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    emulated = run_all({"shards": world, "emulate": True}, jax_mesh)
    return world, ranks, emulated


def _equal(a: dict, b: dict, case: str | None):
    """Arrays of one case (keys ``<case>_<what>``; None: every key)
    equal in value and dtype."""
    def keys(x):
        return sorted(k for k in x if case is None or k.rsplit("_", 1)[0] == case)

    assert keys(a) and keys(a) == keys(b)
    for k in keys(a):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


# ---------------------------------------------------------------------------
# the group form is the emulated form, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [f"ann{B}_{k}" for B, k in ANN_CASES])
def test_group_ann_equals_emulated(group, case):
    _, ranks, emulated = group
    _equal(ranks[0], emulated, case)


@pytest.mark.parametrize("case", ["cp", "cp_pruned"])
def test_group_cp_equals_emulated(group, case):
    _, ranks, emulated = group
    _equal(ranks[0], emulated, case)
    if case == "cp_pruned":
        stats = dict(zip(_stat_names(), ranks[0]["cp_pruned_stats"]))
        assert stats["tiles_pruned"] > 0


def _stat_names():
    from repro_torch.index import WorkStats

    return list(WorkStats().as_dict())


def test_group_pq_equals_emulated(group):
    """Each rank trains its own shard's codec; the emulated mesh trains
    all of them: the same codecs, the same answers."""
    _, ranks, emulated = group
    _equal(ranks[0], emulated, "pq")


def test_every_rank_answers_alike(group):
    world, ranks, _ = group
    for r in range(1, world):
        skip = ("mesh", "psum", "pmax", "gather", "ring", "refused")
        _equal({k: v for k, v in ranks[r].items() if k not in skip},
               {k: v for k, v in ranks[0].items() if k not in skip}, None)


def test_group_collectives(group):
    world, ranks, _ = group
    want_sum = [world * (world + 1) // 2, 10 * world * (world - 1) // 2]
    for r, out in enumerate(ranks):
        assert out["mesh"].tolist() == [world, r, 0]
        assert out["psum"].tolist() == want_sum and out["psum"].dtype == np.int32
        assert out["pmax"].tolist() == [float(world), 10.0 * (world - 1)]
        assert out["gather"].tolist() == [[p + 1, 10 * p] for p in range(world)]
        prev = (r - 1) % world  # shard r receives what r − 1 sent
        assert out["ring"].tolist() == [0.5 * (prev + 1), 5.0 * prev]


def test_group_mesh_refuses_a_mismatch(group):
    """gloo with device="cuda", and a shard count that is not the world's."""
    _, ranks, _ = group
    assert all(out["refused"].tolist() == [1, 1] for out in ranks)


# ---------------------------------------------------------------------------
# against the JAX package's mesh path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["group", "emulated"])
@pytest.mark.parametrize("B", [1, 7])
def test_legacy_ann_equals_jax_mesh(group, jax_mesh, form, B):
    world, ranks, emulated = group
    out = ranks[0] if form == "group" else emulated
    np.testing.assert_array_equal(out[f"legacy{B}_ids"], jax_mesh[f"legacy{world}_ids{B}"])
    np.testing.assert_allclose(out[f"legacy{B}_d"], jax_mesh[f"legacy{world}_d{B}"],
                               rtol=1e-5)


@pytest.mark.parametrize("form", ["group", "emulated"])
def test_legacy_cp_equals_jax_mesh(group, jax_mesh, form):
    world, ranks, emulated = group
    out = ranks[0] if form == "group" else emulated
    np.testing.assert_array_equal(out["legacy_cp_pairs"], jax_mesh[f"legacy{world}_pairs"])
    np.testing.assert_array_equal(out["legacy_cp_d"], jax_mesh[f"legacy{world}_cpd"])
    stats = dict(zip(_stat_names(), out["legacy_cp_stats"]))
    assert stats["pairs_verified"] == jax_mesh[f"legacy{world}_verified"]


def test_sharded_flat_group_equals_jax_mesh(group, jax_mesh):
    world, ranks, _ = group
    out, want = ranks[0], f"flat{world}"
    stats = dict(zip(_stat_names(), out["ann7_10_stats"]))
    np.testing.assert_array_equal(out["ann7_10_ids"], jax_mesh[want + "_ids"])
    np.testing.assert_allclose(out["ann7_10_d"], jax_mesh[want + "_d"], rtol=1e-5)
    assert stats["candidates_selected"] == jax_mesh[want + "_selected"]
    np.testing.assert_array_equal(out["cp_pairs"], jax_mesh[want + "_pairs"])
    np.testing.assert_allclose(out["cp_d"], jax_mesh[want + "_cpd"], rtol=1e-6)
    cp = dict(zip(_stat_names(), out["cp_stats"]))
    assert [cp["pairs_verified"], cp["tiles_pruned"], cp["max_shard_pairs"]] == \
        jax_mesh[want + "_cpstats"].tolist()
