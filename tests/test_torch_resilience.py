"""The port's durability and fault injection (``repro_torch.resilience``)
held against ``repro.resilience``.

* ``_msgpack``: the bytes ``msgpack.packb`` gives for every payload the
  WAL, the snapshot meta and the config blob write, and for seeded edge
  ints, strs, bins, arrays and maps at each size boundary; it decodes
  msgpack's bytes back.
* The reference's WAL, chaos, breaker and commit-dir cases on the port.
* The kill-point sweep and the recovery cases: the port's durable
  streaming index (flat segments, d = 12, 80 seed rows, the reference's
  op script) crashed at every WAL/memory boundary and recovered on the
  CPU, held to a never-crashed twin of its own AND to the JAX index that
  took the same ops, crash and recovery (ids identical; squared
  distances within 1e-6·(max|q|² + max|x|²): the delta scans sum in the
  norm trick, with another BLAS on each side, and cancel in float32 on
  that scale).
* Cross-reading: the reference's ``recover`` reads a directory the port
  wrote and the port's ``recover(..., a=JAX's A)`` one the reference
  wrote, with equal answers; the WAL files, config blobs, snapshot metas
  and content checksums are byte-identical for the same ops.
"""
import dataclasses
import os

import msgpack
import numpy as np
import pytest

from conftest import make_clustered
from repro.core.hashing import ProjectionFamily as JaxFamily
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro.resilience import breaker as jbreaker
from repro.resilience import chaos as jchaos
from repro.resilience import recover as jax_recover
from repro.resilience import wal as jwal
from repro_torch.index import IndexConfig
from repro_torch.resilience import (
    ChaosError,
    CircuitBreaker,
    CorruptSegmentError,
    FaultPlan,
    FaultSpec,
    RecoveryError,
    WriteAheadLog,
    chaos,
    latest_snapshot,
    recover,
    scan_wal,
)
from repro_torch.resilience import _msgpack
from repro_torch.resilience.fsio import commit_dir
from repro_torch.stream import StreamingIndex

D = 12
K = 8
SEED_N = 80
STREAM_OPTS = {"delta_threshold": 10_000, "max_segments": 10,
               "max_dead_fraction": 1.0, "segment_backend": "flat"}
A = np.asarray(JaxFamily.create(D, 15, seed=0).a)


@pytest.fixture(scope="module")
def data():
    return _DATA


@pytest.fixture(scope="module")
def queries(data):
    return data[300:316] + 1e-3


def _opts(directory=None, **dur):
    opts = dict(STREAM_OPTS)
    if directory is not None:
        opts["durability"] = {"dir": str(directory), **dur}
    return opts


def build(rows, directory=None, **dur):
    """The port's streaming index on the CPU with the JAX family's A."""
    return StreamingIndex.from_arrays(
        rows, A, IndexConfig(backend="streaming", seed=0, options=_opts(directory, **dur)),
        device="cpu")


def jbuild(rows, directory=None, **dur):
    return jax_build_index(rows, JaxConfig(backend="streaming", seed=0,
                                           options=_opts(directory, **dur)))


def make_ops(data):
    return [
        ("insert", data[SEED_N: SEED_N + 30]),
        ("delete", [5, 17, 33]),
        ("flush",),
        ("insert", data[SEED_N + 30: SEED_N + 55]),
        ("delete", [60, 81, 99, 2]),
        ("flush",),
    ]


def apply_op(index, op):
    if op[0] == "insert":
        index.insert(op[1])
    elif op[0] == "delete":
        index.delete(np.asarray(op[1], dtype=np.int64))
    else:
        index.flush()


def build_twin(data, ops):
    twin = build(data[:SEED_N])
    for op in ops:
        apply_op(twin, op)
    return twin


def assert_close_to_jax(rt, rj, queries):
    """ids identical, d² within the norm trick's float32 cancellation."""
    np.testing.assert_array_equal(rt.indices, rj.indices)
    scale = float((queries ** 2).sum(1).max()) + float((_DATA ** 2).sum(1).max())
    np.testing.assert_allclose(rt.distances.astype(np.float64) ** 2,
                               rj.distances.astype(np.float64) ** 2, rtol=0,
                               atol=1e-6 * scale)


_DATA = make_clustered(400, D, n_clusters=8, seed=0)


def assert_equiv(recovered, twin, queries):
    assert np.array_equal(np.sort(recovered.live_ids()), np.sort(twin.live_ids()))
    assert (recovered.n, recovered.segment_count, recovered.n_flushes,
            recovered.n_compactions) == (twin.n, twin.segment_count, twin.n_flushes,
                                         twin.n_compactions)
    if recovered.n == 0:
        return
    ra, rb = recovered.search(queries, k=K), twin.search(queries, k=K)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    np.testing.assert_array_equal(ra.distances, rb.distances)


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def _payloads(data):
    x = np.ascontiguousarray(data[:7], dtype=np.float32)
    ids = np.arange(5, dtype=np.int64) * 3
    return {
        "insert": {"op": "insert", "id0": 80, "n": 7, "d": D, "vec": x.tobytes()},
        "insert_big": {"op": "insert", "id0": 2**33, "n": 1000, "d": 300,
                       "vec": b"\x01" * (1000 * 300 * 4)},
        "delete": {"op": "delete", "ids": ids.tobytes()},
        "flush": {"op": "flush"},
        "compact": {"op": "compact"},
        "meta": {"format": 1, "lsn": 70_000, "d": D, "total": 300, "n_flushes": 3,
                 "n_compactions": 1,
                 "segments": [{"file": f"seg_{i}.npz", "n": 10 ** i} for i in range(5)],
                 "checksums": {f"seg_{i}.npz": "ab" * 16 for i in range(20)}},
        "config": {"d": 256, "config": {
            "backend": "streaming", "c": 1.5, "cp_c": 4.0, "m": 15, "seed": -3,
            "default_k": 10, "options": {"segment_backend": "flat", "delta_threshold": 32768,
                                         "quant": None, "fused": True, "cp_gamma": 0.75,
                                         "pq": {"m_codebooks": 16}, "list": [1, 2.5, "x"]}},
            "durability": {"sync": True, "snapshot_every": 0, "snapshot_keep": 2}},
    }


@pytest.mark.parametrize("name", ["insert", "insert_big", "delete", "flush", "compact",
                                  "meta", "config"])
def test_msgpack_payloads_byte_identical(name, data):
    obj = _payloads(data)[name]
    want = msgpack.packb(obj)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want) == obj


def _edges(kind, rng):
    bounds = {
        "int": [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 2**32 - 1, 2**32,
                2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31,
                -2**31 - 1, -2**63],
        "str": [31, 32, 255, 256, 65535, 65536],
        "bin": [0, 1, 255, 256, 65535, 65536],
        "array": [0, 15, 16, 65535, 65536],
        "map": [0, 15, 16, 65536],
    }[kind]
    out = []
    for b in bounds:
        if kind == "int":
            out += [b, int(rng.integers(-2**62, 2**62))]
        elif kind == "str":
            out.append("".join(rng.choice(list("abcé€𝄞"), b)).encode("utf-8")[:b]
                       .decode("utf-8", "ignore"))
            out.append("x" * b)
        elif kind == "bin":
            out.append(rng.integers(0, 256, b, dtype=np.uint8).tobytes())
        elif kind == "array":
            out.append([int(v) for v in rng.integers(-100, 100, b)])
        else:
            out.append({f"k{i}": float(rng.normal()) for i in range(b)})
    return out


@pytest.mark.parametrize("kind", ["int", "str", "bin", "array", "map"])
def test_msgpack_edges_at_every_size_boundary(kind):
    rng = np.random.default_rng(len(kind))
    for value in _edges(kind, rng) + [None, True, False, 0.0, -2.5e-300, float("inf")]:
        want = msgpack.packb(value)
        assert _msgpack.packb(value) == want
        back = _msgpack.unpackb(want)
        assert back == msgpack.unpackb(want)


def test_msgpack_rejects_what_it_does_not_carry():
    for bad in (object(), {1, 2}, np.int64(3), 1 + 2j):
        with pytest.raises(TypeError):
            _msgpack.packb(bad)
    with pytest.raises(TypeError):  # an ext type, outside the subset
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    assert _msgpack.unpackb(msgpack.packb(np.float32(0.5).item())) == 0.5
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb({"a": 1})[:-1])


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------


class TestWal:
    def test_roundtrip_reopen_continues_lsn(self, tmp_path):
        p = tmp_path / "wal.log"
        w = WriteAheadLog(p, base_lsn=5)
        lsns = [w.append({"op": "x", "i": i}) for i in range(4)]
        w.close()
        assert lsns == [5, 6, 7, 8]
        base, recs, _ = scan_wal(p)
        assert base == 5
        assert [r.payload["i"] for r in recs] == [0, 1, 2, 3]
        w2 = WriteAheadLog(p)
        assert w2.append({"op": "x", "i": 4}) == 9
        w2.close()
        assert len(scan_wal(p)[1]) == 5

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        p = tmp_path / "wal.log"
        with WriteAheadLog(p) as w:
            for i in range(3):
                w.append({"op": "x", "i": i})
        with open(p, "ab") as f:  # torn record: header bytes, no body
            f.write(b"\xff" * 7)
        _, recs, valid = scan_wal(p)
        assert len(recs) == 3 and valid == p.stat().st_size - 7
        w = WriteAheadLog(p)  # reopen physically drops the tail
        assert p.stat().st_size == valid
        w.append({"op": "x", "i": 3})
        w.close()
        assert len(scan_wal(p)[1]) == 4

    def test_mid_log_corruption_stops_scan(self, tmp_path):
        p = tmp_path / "wal.log"
        with WriteAheadLog(p) as w:
            w.append({"op": "x", "i": 0})
        _, _, first_end = scan_wal(p)
        with WriteAheadLog(p) as w:
            for i in range(1, 4):
                w.append({"op": "x", "i": i})
        blob = bytearray(p.read_bytes())
        blob[first_end + 4] ^= 0x40  # inside record 2
        p.write_bytes(bytes(blob))
        _, recs, valid = scan_wal(p)
        assert len(recs) == 1 and valid == first_end  # durable prefix only

    def test_bad_header_rejected(self, tmp_path):
        p = tmp_path / "wal.log"
        p.write_bytes(b"NOTAWAL0" + b"\x00" * 8)
        with pytest.raises(ValueError):
            scan_wal(p)

    def test_same_records_same_file_as_the_reference(self, tmp_path, data):
        payloads = list(_payloads(data).values())
        for mod, name in ((jwal, "j.log"), (None, "t.log")):
            cls = mod.WriteAheadLog if mod is not None else WriteAheadLog
            with cls(tmp_path / name, base_lsn=3, sync=False) as w:
                for p in payloads:
                    w.append(p)
        assert (tmp_path / "j.log").read_bytes() == (tmp_path / "t.log").read_bytes()
        _, jrecs, _ = jwal.scan_wal(tmp_path / "t.log")  # each reads the other's
        _, trecs, _ = scan_wal(tmp_path / "j.log")
        assert [r.payload for r in trecs] == [r.payload for r in jrecs] == payloads


# ---------------------------------------------------------------------------
# chaos harness
# ---------------------------------------------------------------------------


class TestChaos:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            FaultSpec("wal.append", "explode")
        for kind in ("error", "latency", "bitflip", "drop", "nonfinite"):
            FaultSpec("serve.search", kind)  # the reference's five kinds
            jchaos.FaultSpec("serve.search", kind)

    def test_at_fires_exactly_once(self):
        plan = FaultPlan([FaultSpec("s", "error", at=2)])
        for i in range(5):
            if i == 2:
                with pytest.raises(ChaosError):
                    plan.on_hit("s")
            else:
                plan.on_hit("s")
        assert plan.fired() == {("s", "error"): 1}

    def test_probabilistic_firing_is_deterministic(self):
        def run(mod, seed):
            plan = mod.FaultPlan([mod.FaultSpec("s", "drop", prob=0.3, times=0)], seed=seed)
            return [plan.on_dropped("s") for _ in range(50)]

        assert run(chaos, 7) == run(chaos, 7) == run(jchaos, 7)
        assert run(chaos, 7) != run(chaos, 8)
        assert any(run(chaos, 7)) and not all(run(chaos, 7))

    def test_times_caps_firing(self):
        plan = FaultPlan([FaultSpec("s", "drop", prob=1.0, times=2)])
        assert sum(plan.on_dropped("s") for _ in range(10)) == 2

    def test_bitflip_changes_bytes_preserves_length(self):
        data = bytes(range(64))
        outs = []
        for mod in (chaos, jchaos):
            plan = mod.FaultPlan([mod.FaultSpec("s", "bitflip", at=0, flip_bits=3)], seed=3)
            out = plan.on_bytes("s", data)
            assert out != data and len(out) == len(data)
            assert plan.on_bytes("s", data) == data  # fired once only
            outs.append(out)
        assert outs[0] == outs[1]  # the reference's flips, bit for bit

    def test_active_restores_previous_plan(self):
        outer = FaultPlan([])
        inner = FaultPlan([])
        assert chaos.current_plan() is None
        with chaos.active(outer):
            with chaos.active(inner):
                assert chaos.current_plan() is inner
            assert chaos.current_plan() is outer
        assert chaos.current_plan() is None

    def test_hooks_are_noops_without_plan(self):
        chaos.hit("anything")
        chaos.hit("anything", budget_s=0.0)
        assert chaos.transform("anything", b"abc") == b"abc"
        assert not chaos.dropped("anything")
        assert not chaos.poisoned("anything")

    def test_latency_respects_budget(self):
        """A straggler under its caller's budget only sleeps; past it the
        plan sleeps the budget and raises ChaosLatencyExceeded (a
        ChaosError), as the reference's (its :189-200)."""
        slept, said = {}, []
        for mod in (chaos, jchaos):
            out = slept[mod] = []
            plan = mod.FaultPlan([mod.FaultSpec("s", "latency", at=0, latency_s=1.0, times=0),
                                  mod.FaultSpec("s", "latency", at=1, latency_s=0.05)])
            plan.sleep = out.append
            with pytest.raises(mod.ChaosLatencyExceeded) as got:
                plan.on_hit("s", budget_s=0.1)  # abandoned at the deadline
            assert isinstance(got.value, mod.ChaosError)
            assert (got.value.site, got.value.latency_s, got.value.budget_s) == ("s", 1.0, 0.1)
            plan.on_hit("s", budget_s=0.1)  # under budget: just slow
            plan.on_hit("s")  # nothing due on the third access
            assert plan.fired() == {("s", "latency"): 2}
            said.append(str(got.value))
        assert slept[chaos] == slept[jchaos] == [0.1, 0.05]
        assert said[0] == said[1]

    def test_latency_without_budget_sleeps_in_full(self):
        slept = []
        plan = FaultPlan([FaultSpec("wal.append", "latency", at=0, latency_s=2.5)])
        plan.sleep = slept.append
        with chaos.active(plan):
            chaos.hit("wal.append")  # a straggling WAL write, no budget
        assert slept == [2.5]

    def test_poisoned_consumes_only_nonfinite_specs(self):
        """``poisoned`` advances only nonfinite specs, ``hit`` only error
        and latency ones: mixing accessors at one site stays
        deterministic, and both frameworks fire on the same accesses."""
        seqs = []
        for mod in (chaos, jchaos):
            plan = mod.FaultPlan([mod.FaultSpec("q", "nonfinite", at=1),
                                  mod.FaultSpec("q", "error", at=0),
                                  mod.FaultSpec("q", "nonfinite", prob=0.5, times=0)], seed=4)
            seq = []
            with mod.active(plan):
                with pytest.raises(mod.ChaosError):
                    mod.hit("q")
                seq += [mod.poisoned("q") for _ in range(12)]
                mod.hit("q")  # the error spec fired once already
            assert plan.fired()[("q", "error")] == 1
            seqs.append((seq, plan.fired()))
        assert seqs[0] == seqs[1]
        assert seqs[0][0][1]  # the at=1 spec

    def test_known_sites_are_the_reference_s(self):
        assert chaos.KNOWN_SITES == jchaos.KNOWN_SITES
        assert chaos.KNOWN_SITES["wal.append"] == ("error", "latency")
        assert {s for s in chaos.KNOWN_SITES if s.startswith("serve.")} == {
            "serve.flush", "serve.search", "serve.degraded", "serve.cache"}

    @pytest.mark.parametrize("sites", [None, ("serve.search",),
                                       ("serve.search", "serve.degraded", "serve.flush")])
    def test_seeded_covers_site_kinds(self, sites):
        """One probabilistic spec per (site, kind) the site supports —
        every site's kinds when none are named — and the same firing
        trajectory as the reference's plan for the same seed."""
        plan = FaultPlan.seeded(0, sites=sites)
        jplan = jchaos.FaultPlan.seeded(0, sites=sites)
        want = {(s, k) for s in (sites or chaos.KNOWN_SITES) for k in chaos.KNOWN_SITES[s]}
        assert {(s.site, s.kind) for s in plan.specs} == want
        assert [dataclasses.astuple(s) for s in plan.specs] == [
            dataclasses.astuple(s) for s in jplan.specs]
        if sites == ("serve.search",):
            assert want == {("serve.search", "error"), ("serve.search", "latency")}
        runs = []
        for mod, p in ((chaos, plan), (jchaos, jplan)):
            p.sleep = lambda s: None
            trail = []
            for i in range(400):
                site = sorted(want)[i % len(want)][0]
                try:
                    p.on_hit(site, budget_s=0.01)
                    trail.append((site, "ok"))
                except mod.ChaosError as e:
                    trail.append((site, type(e).__name__))
                trail.append(p.on_dropped(site))
                trail.append(p.on_poisoned(site))
                trail.append(p.on_bytes(site, b"abcd"))
            runs.append((trail, p.fired()))
        assert runs[0] == runs[1]
        assert runs[0][1] and max(runs[0][1].values()) <= 3  # times=3 caps each spec


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class TestBreaker:
    def make(self, mod=None, **kw):
        self.t = [0.0]
        events = []
        cls = CircuitBreaker if mod is None else mod.CircuitBreaker
        br = cls(window=4, failure_threshold=0.5, min_calls=4, reset_timeout_s=10.0,
                 clock=lambda: self.t[0], on_transition=lambda o, n: events.append((o, n)),
                 **kw)
        return br, events

    def test_stays_closed_below_min_calls(self):
        br, _ = self.make()
        for _ in range(3):
            br.record_failure()
        assert br.state == "closed" and br.allow()

    def test_trips_open_and_blocks(self):
        br, events = self.make()
        for _ in range(4):
            br.record_failure()
        assert br.state == "open" and not br.allow()
        assert br.state_code() == 1.0
        assert events == [("closed", "open")]

    def test_half_open_single_probe_then_close(self):
        br, events = self.make()
        for _ in range(4):
            br.record_failure()
        self.t[0] = 11.0
        assert br.allow()  # OPEN → HALF_OPEN, probe admitted
        assert br.state == "half_open" and br.state_code() == 2.0
        assert not br.allow()  # one probe at a time
        br.record_success()
        assert br.state == "closed" and br.failure_rate() == 0.0
        assert events[-1] == ("half_open", "closed")

    def test_half_open_failure_reopens_with_fresh_timer(self):
        br, _ = self.make()
        for _ in range(4):
            br.record_failure()
        self.t[0] = 11.0
        assert br.allow()
        br.record_failure()
        assert br.state == "open" and not br.allow()
        self.t[0] = 20.9  # timer restarted at t=11, not t=0
        assert not br.allow()
        self.t[0] = 21.1
        assert br.allow()
        assert br.transitions == 4

    def test_same_trajectory_as_the_reference(self):
        rng = np.random.default_rng(5)
        steps = rng.integers(0, 4, 200)
        trails = []
        for mod in (None, jbreaker):
            br, events = self.make(mod)
            trail = []
            for s in steps:
                self.t[0] += 1.5
                if s == 0:
                    trail.append(br.allow())
                elif s == 1:
                    br.record_success()
                else:
                    br.record_failure()
                trail.append((br.state, br.failure_rate()))
            trails.append((trail, events, br.transitions))
        assert trails[0] == trails[1]


class TestCommitDir:
    def test_commit_protocol(self, tmp_path):
        tmp = tmp_path / "work.tmp"
        tmp.mkdir()
        (tmp / "payload.bin").write_bytes(b"\x01" * 128)
        final = commit_dir(tmp, tmp_path / "work")
        assert final == tmp_path / "work"
        assert not tmp.exists()
        assert (final / "COMMIT").exists()
        assert (final / "payload.bin").read_bytes() == b"\x01" * 128


# ---------------------------------------------------------------------------
# kill-point sweep: crash at every WAL/memory boundary, recover, compare,
# the JAX index beside it taking the same script and crash
# ---------------------------------------------------------------------------


def _run_killed(directory, data, ops, spec, *, jax_side=False):
    mod = jchaos if jax_side else chaos
    crashed_at = None
    idx = None
    with mod.active(mod.FaultPlan([mod.FaultSpec(**spec)])):
        try:
            idx = (jbuild if jax_side else build)(data[:SEED_N], directory)
            for i, op in enumerate(ops):
                apply_op(idx, op)
        except mod.ChaosError:
            crashed_at = -1 if idx is None else i
    if idx is not None:
        idx.durability.close()  # drop the fd; state is "crashed"
    return crashed_at


def _held_to_jax(tmp_path, name, data, ops, spec, queries):
    """The port's and the reference's crash on the same spec: the same
    crash point, the same WAL bytes, equal recovered answers."""
    dt, dj = tmp_path / f"{name}_t", tmp_path / f"{name}_j"
    crashed = _run_killed(dt, data, ops, spec)
    assert crashed == _run_killed(dj, data, ops, spec, jax_side=True)
    assert (dt / "wal.log").read_bytes() == (dj / "wal.log").read_bytes()
    recovered, report = recover(dt, device="cpu", a=A)
    jrec, jrep = jax_recover(dj)
    np.testing.assert_array_equal(np.sort(recovered.live_ids()), np.sort(jrec.live_ids()))
    if recovered.n:
        assert_close_to_jax(recovered.search(queries, K), jrec.search(queries, K), queries)
    for field in ("snapshot_lsn", "records_replayed", "records_skipped",
                  "torn_bytes_truncated", "bytes_verified"):
        assert getattr(report, field) == getattr(jrep, field)
    jrec.close()
    return crashed, recovered, report


class TestKillPointSweep:
    @pytest.mark.parametrize("j", range(7))
    def test_kill_before_wal_write_excludes_op(self, tmp_path, data, queries, j):
        """A crash BEFORE the WAL write (access j) loses exactly that op."""
        ops = make_ops(data)
        crashed, recovered, report = _held_to_jax(
            tmp_path, "wal", data, ops, dict(site="wal.append", kind="error", at=j), queries)
        assert crashed == (-1 if j == 0 else j - 1)
        twin = build(data[:0]) if j == 0 else build_twin(data, ops[: j - 1])
        assert_equiv(recovered, twin, queries)
        assert report.records_replayed == j
        recovered.close()

    @pytest.mark.parametrize("j", range(7))
    def test_kill_after_wal_write_includes_op(self, tmp_path, data, queries, j):
        """A crash AFTER the WAL write but BEFORE the memory mutation keeps
        the op: the log dominates memory."""
        ops = make_ops(data)
        _, recovered, report = _held_to_jax(
            tmp_path, "apply", data, ops, dict(site="stream.apply", kind="error", at=j),
            queries)
        assert_equiv(recovered, build_twin(data, ops[:j]), queries)
        assert report.records_replayed == j + 1
        recovered.close()

    @pytest.mark.parametrize("site", ["snapshot.write", "snapshot.commit"])
    def test_kill_during_snapshot_falls_back_to_wal(self, tmp_path, data, queries, site):
        ops = make_ops(data)
        dirs = {}
        for mod, side, make in ((chaos, "t", build), (jchaos, "j", jbuild)):
            d = dirs[side] = tmp_path / f"{site}_{side}"
            with mod.active(mod.FaultPlan([mod.FaultSpec(site, "error", at=0)])):
                idx = make(data[:SEED_N], d)
                for op in ops[:3]:
                    apply_op(idx, op)
                with pytest.raises(mod.ChaosError):
                    idx.snapshot()
            idx.durability.close()
            assert latest_snapshot(d) is None  # nothing committed
        recovered, report = recover(dirs["t"], device="cpu", a=A)
        assert report.snapshot_lsn is None
        assert report.records_replayed == 4  # seed + 3 ops, full replay
        assert_equiv(recovered, build_twin(data, ops[:3]), queries)
        jrec, _ = jax_recover(dirs["j"])
        np.testing.assert_array_equal(recovered.search(queries, K).indices,
                                      jrec.search(queries, K).indices)
        recovered.close()
        jrec.close()

    def test_crash_after_snapshot_replays_only_tail(self, tmp_path, data, queries):
        ops = make_ops(data)
        dirs = {}
        for mod, side, make in ((chaos, "t", build), (jchaos, "j", jbuild)):
            d = dirs[side] = tmp_path / f"tail_{side}"
            with mod.active(mod.FaultPlan([mod.FaultSpec("stream.apply", "error", at=5)])):
                idx = make(data[:SEED_N], d)
                for op in ops[:3]:
                    apply_op(idx, op)
                idx.snapshot()  # durable through ops[2]; WAL rotated
                apply_op(idx, ops[3])
                with pytest.raises(mod.ChaosError):
                    apply_op(idx, ops[4])  # logged, crash before memory
            idx.durability.close()
        snap_t, snap_j = latest_snapshot(dirs["t"]), latest_snapshot(dirs["j"])
        assert snap_t.name == snap_j.name
        assert (snap_t / "meta.msgpack").read_bytes() == (snap_j / "meta.msgpack").read_bytes()
        assert (dirs["t"] / "wal.log").read_bytes() == (dirs["j"] / "wal.log").read_bytes()
        recovered, report = recover(dirs["t"], device="cpu", a=A)
        assert report.snapshot_lsn is not None
        assert report.records_replayed == 2  # ops[3], ops[4] only
        assert_equiv(recovered, build_twin(data, ops[:5]), queries)
        jrec, jrep = jax_recover(dirs["j"])
        assert jrep.records_replayed == 2
        np.testing.assert_array_equal(recovered.search(queries, K).indices,
                                      jrec.search(queries, K).indices)
        recovered.close()
        jrec.close()


# ---------------------------------------------------------------------------
# recovery: torn tails, corruption refusal, guards, lifecycle
# ---------------------------------------------------------------------------


def _jax_copy(directory):
    """A copy of ``directory`` for the reference's ``recover`` (each
    recovery truncates torn tails and keeps logging in its own)."""
    import shutil

    copy = directory.parent / (directory.name + "_jax")
    shutil.copytree(directory, copy)
    return copy


def _same_as_jax_recovery(recovered, report, jax_dir, queries):
    """The reference recovers the same directory to the same answer."""
    jrec, jrep = jax_recover(jax_dir)
    for field in ("snapshot_lsn", "records_replayed", "records_skipped",
                  "torn_bytes_truncated", "bytes_verified"):
        assert getattr(report, field) == getattr(jrep, field)
    np.testing.assert_array_equal(np.sort(recovered.live_ids()), np.sort(jrec.live_ids()))
    assert_close_to_jax(recovered.search(queries, K), jrec.search(queries, K), queries)
    jrec.close()


class TestRecovery:
    def finish(self, directory, data, ops, **dur):
        idx = build(data[:SEED_N], directory, **dur)
        for op in ops:
            apply_op(idx, op)
        return idx

    def test_clean_roundtrip_with_compaction(self, tmp_path, data, queries):
        """No crash, no snapshot: full WAL replay reproduces flushes AND
        compactions (derived records replay as no-ops); the JAX index fed
        the same ops writes the same WAL and recovers to the same answer."""
        opts = {"delta_threshold": 40, "max_segments": 2, "max_dead_fraction": 0.3,
                "segment_backend": "flat"}
        dt, dj = tmp_path / "clean_t", tmp_path / "clean_j"
        idx = StreamingIndex.from_arrays(
            data[:SEED_N], A, IndexConfig(backend="streaming", seed=0, options={
                **opts, "durability": {"dir": str(dt)}}), device="cpu")
        jidx = jax_build_index(data[:SEED_N], JaxConfig(backend="streaming", seed=0, options={
            **opts, "durability": {"dir": str(dj)}}))
        rng = np.random.default_rng(3)
        pos = SEED_N
        for _ in range(4):
            for index in (idx, jidx):
                index.insert(data[pos: pos + 50])
            pos += 50
            kill = rng.choice(idx.live_ids(), 12, replace=False)
            assert idx.delete(kill) == jidx.delete(kill)
        assert idx.n_compactions == jidx.n_compactions >= 1
        idx.close()
        jidx.close()
        assert (dt / "wal.log").read_bytes() == (dj / "wal.log").read_bytes()
        assert (dt / "config.msgpack").read_bytes() == (dj / "config.msgpack").read_bytes()
        recovered, report = recover(dt, device="cpu", a=A)
        assert_equiv(recovered, idx, queries)
        assert report.records_replayed > 0
        jrec, _ = jax_recover(dt)  # the reference reads the port's directory
        np.testing.assert_array_equal(recovered.search(queries, K).indices,
                                      jrec.search(queries, K).indices)
        assert (jrec.n_flushes, jrec.n_compactions) == (idx.n_flushes, idx.n_compactions)
        recovered.close()
        jrec.close()

    def test_torn_tail_is_truncated_not_replayed(self, tmp_path, data, queries):
        d = tmp_path / "torn"
        ops = make_ops(data)
        self.finish(d, data, ops).close()
        wal = d / "wal.log"
        size = wal.stat().st_size
        with open(wal, "ab") as f:  # crash mid-append of a later record
            f.write(b"\x13\x00\x00\x00garbage")
        jax_dir = _jax_copy(d)
        recovered, report = recover(d, device="cpu", a=A)
        assert report.torn_bytes_truncated == wal.stat().st_size - size + 11
        assert wal.stat().st_size >= size  # truncated, then reopened
        assert_equiv(recovered, build_twin(data, ops), queries)
        _same_as_jax_recovery(recovered, report, jax_dir, queries)
        recovered.close()
        recovered2, report2 = recover(d, device="cpu", a=A)
        assert report2.torn_bytes_truncated == 0
        recovered2.close()

    def test_chopped_final_record_drops_that_op(self, tmp_path, data, queries):
        d = tmp_path / "chopped"
        ops = make_ops(data)
        self.finish(d, data, ops).close()
        wal = d / "wal.log"
        wal.write_bytes(wal.read_bytes()[:-3])  # disk lost the tail
        jax_dir = _jax_copy(d)
        recovered, report = recover(d, device="cpu", a=A)
        assert_equiv(recovered, build_twin(data, ops[:-1]), queries)
        _same_as_jax_recovery(recovered, report, jax_dir, queries)
        recovered.close()

    def test_corrupt_snapshot_segment_refused(self, tmp_path, data):
        d = tmp_path / "corrupt"
        idx = self.finish(d, data, make_ops(data))
        idx.snapshot()
        idx.close()
        snap = latest_snapshot(d)
        seg = sorted(snap.glob("seg_*.npz"))[0]
        blob = bytearray(seg.read_bytes())
        blob[len(blob) // 2] ^= 0x10
        seg.write_bytes(bytes(blob))
        with pytest.raises(CorruptSegmentError):
            recover(d, device="cpu", a=A)
        from repro.resilience import CorruptSegmentError as JaxCorrupt

        with pytest.raises(JaxCorrupt):  # the reference refuses it too
            jax_recover(d)

    def test_bitflip_at_segment_load_caught_by_checksum(self, tmp_path, data):
        d = tmp_path / "bitflip"
        idx = self.finish(d, data, make_ops(data))
        idx.snapshot()
        idx.close()
        plan = FaultPlan([FaultSpec("segment.load", "bitflip", at=0, flip_bits=3)], seed=5)
        with chaos.active(plan):
            with pytest.raises(CorruptSegmentError) as got:
                recover(d, device="cpu", a=A)
        assert plan.fired() == {("segment.load", "bitflip"): 1}
        jplan = jchaos.FaultPlan([jchaos.FaultSpec("segment.load", "bitflip", at=0,
                                                   flip_bits=3)], seed=5)
        with jchaos.active(jplan), pytest.raises(RuntimeError) as jgot:
            jax_recover(d)  # the same flips, the same refusal
        assert str(got.value) == str(jgot.value)
        recovered, _ = recover(d, device="cpu", a=A)  # the disk itself is fine
        assert recovered.n > 0
        recovered.close()

    def test_fresh_build_refuses_existing_dir(self, tmp_path, data):
        d = tmp_path / "occupied"
        self.finish(d, data, []).close()
        with pytest.raises(RecoveryError):
            build(data[:SEED_N], d)

    def test_unwritable_directory_raises(self, tmp_path, data):
        """No fallback: a durable index whose directory cannot be made
        raises at build instead of running without its WAL."""
        blocker = tmp_path / "a_file"
        blocker.write_bytes(b"x")
        with pytest.raises(OSError):
            build(data[:SEED_N], blocker / "dir")

    def test_snapshot_gc_keeps_newest(self, tmp_path, data):
        d = tmp_path / "gc"
        idx = self.finish(d, data, [], snapshot_keep=1)
        for chunk in range(3):
            idx.insert(data[SEED_N + chunk * 10: SEED_N + chunk * 10 + 10])
            idx.snapshot()
        idx.close()
        snaps = [p for p in d.iterdir() if p.name.startswith("snap_")]
        assert len(snaps) == 1 and latest_snapshot(d) == snaps[0]

    def test_snapshot_every_triggers_automatically(self, tmp_path, data, queries):
        d = tmp_path / "auto"
        idx = self.finish(d, data, make_ops(data), snapshot_every=3)
        idx.close()
        assert latest_snapshot(d) is not None
        jax_dir = _jax_copy(d)
        recovered, report = recover(d, device="cpu", a=A)
        assert report.snapshot_lsn is not None
        assert_equiv(recovered, build_twin(data, make_ops(data)), queries)
        _same_as_jax_recovery(recovered, report, jax_dir, queries)
        recovered.close()

    def test_recovered_index_keeps_logging(self, tmp_path, data, queries):
        """recover() hands back a LIVE durable index: post-recovery ops
        survive a second crash/recover cycle."""
        d = tmp_path / "relog"
        ops = make_ops(data)
        self.finish(d, data, ops[:3]).close()
        mid, _ = recover(d, device="cpu", a=A)
        for op in ops[3:]:
            apply_op(mid, op)
        mid.close()
        jax_dir = _jax_copy(d)
        final, report = recover(d, device="cpu", a=A)
        assert_equiv(final, build_twin(data, ops), queries)
        _same_as_jax_recovery(final, report, jax_dir, queries)
        final.close()

    def test_snapshot_needs_durability_and_close_is_a_noop_without(self, data):
        idx = build(data[:SEED_N])
        with pytest.raises(RuntimeError, match="durability"):
            idx.snapshot()
        idx.close()


# ---------------------------------------------------------------------------
# across the frameworks
# ---------------------------------------------------------------------------


class TestCrossReading:
    def _write_both(self, tmp_path, data, ops):
        dirs = {}
        for side, make in (("t", build), ("j", jbuild)):
            d = dirs[side] = tmp_path / side
            idx = make(data[:SEED_N], d, snapshot_every=3)
            for op in ops[:4]:
                apply_op(idx, op)
            idx.snapshot()
            for op in ops[4:]:
                apply_op(idx, op)
            idx.close()
        return dirs

    def test_files_are_byte_identical_for_the_same_ops(self, tmp_path, data):
        from repro.resilience.snapshot import load_snapshot as jload

        dirs = self._write_both(tmp_path, data, make_ops(data))
        for name in ("wal.log", "config.msgpack"):
            assert (dirs["t"] / name).read_bytes() == (dirs["j"] / name).read_bytes()
        snaps = {side: sorted(p.name for p in d.iterdir() if p.name.startswith("snap_"))
                 for side, d in dirs.items()}
        assert snaps["t"] == snaps["j"] and len(snaps["t"]) == 2
        for name in snaps["t"]:
            st, sj = dirs["t"] / name, dirs["j"] / name
            assert (st / "meta.msgpack").read_bytes() == (sj / "meta.msgpack").read_bytes()
            meta = msgpack.unpackb((st / "meta.msgpack").read_bytes())
            assert meta["checksums"] == msgpack.unpackb(
                (sj / "meta.msgpack").read_bytes())["checksums"]
            a, b = jload(st), jload(sj)  # the reference verifies the port's payloads
            assert a.bytes_verified > 0 and a.total == b.total
            np.testing.assert_array_equal(a.alive, b.alive)

    def test_each_recovers_the_others_directory(self, tmp_path, data, queries):
        dirs = self._write_both(tmp_path, data, make_ops(data))
        jrec, jrep = jax_recover(dirs["t"])      # JAX reads the port's
        trec, trep = recover(dirs["j"], device="cpu", a=A)  # the port reads JAX's
        assert jrep.snapshot_lsn == trep.snapshot_lsn is not None
        assert jrep.records_replayed == trep.records_replayed
        np.testing.assert_array_equal(np.sort(jrec.live_ids()), np.sort(trec.live_ids()))
        assert_close_to_jax(trec.search(queries, K), jrec.search(queries, K), queries)
        assert (trec.n_flushes, trec.segment_count) == (jrec.n_flushes, jrec.segment_count)
        # both keep logging, each in the other's directory
        extra = data[SEED_N + 60: SEED_N + 70]
        trec.insert(extra)
        jrec.insert(extra)
        trec.close()
        jrec.close()
        again_t, _ = jax_recover(dirs["j"])
        again_j, _ = recover(dirs["t"], device="cpu", a=A)
        np.testing.assert_array_equal(again_t.search(queries, K).indices,
                                      again_j.search(queries, K).indices)
        again_t.close()
        again_j.close()

    def test_recover_draws_a_from_the_persisted_seed(self, tmp_path, data, queries):
        """Without ``a`` recovery draws A as build_index does, so an index
        the port built from its own seed comes back answering the same."""
        from repro_torch.index import build_index

        d = tmp_path / "own"
        cfg = IndexConfig(backend="streaming", seed=4, options=_opts(d))
        idx = build_index(data[:SEED_N], cfg, device="cpu")
        for op in make_ops(data):
            apply_op(idx, op)
        want = idx.search(queries, K)
        idx.close()
        rec, _ = recover(d, device="cpu")
        np.testing.assert_array_equal(rec._a, idx._a)
        got = rec.search(queries, K)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)
        rec.close()


def test_wal_metrics_count_the_records(tmp_path, data):
    from repro_torch.obs import get_registry

    reg = get_registry()
    before = reg.snapshot()
    idx = build(data[:SEED_N], tmp_path / "m")
    for op in make_ops(data):
        apply_op(idx, op)
    idx.snapshot()
    idx.close()
    rec, _ = recover(tmp_path / "m", device="cpu", a=A)
    rec.close()
    delta = reg.delta(reg.snapshot(), before)
    records = {k: v for k, v in delta["wal_records_total"]["series"].items() if v}
    assert records == {"op=insert": 3.0, "op=delete": 2.0, "op=flush": 2.0}
    assert delta["snapshot_commits_total"]["series"][""] == 1.0
    assert delta["wal_fsync_seconds"]["series"][""]["count"] >= 7
    assert "recovery_replayed_total" in delta
    prom = reg.to_prometheus()
    for name in ("wal_records_total", "wal_fsync_seconds", "recovery_replayed_total",
                 "snapshot_commits_total"):
        assert f"# TYPE {name}" in prom
    assert os.path.exists(tmp_path / "m" / "config.msgpack")
