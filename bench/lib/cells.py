"""The one general traffic generator: each traffic file names a ``kind``,
and its parameters drive that kind of load through the program's entry.

  batch_search  one closed-loop client calling ``FlatBackend.search`` back
                to back with ``batch`` fresh queries a call
  cp_search     one closed-loop client calling ``FlatBackend.cp_search(k)``
                back to back, k cycling through ``k_choices``
  serve_open    open-loop arrivals at ``rate_qps`` into a
                ``RequestScheduler`` over ``make_retrieval_step``, pumped
                in one loop; each request timed from when it was due

A kind makes its inputs from the seed (``bench.lib.data``), builds the
program's index, warms the shapes its traffic uses, runs the measured
window, runs the traced slices, frees the program's state and then holds
what the window produced against the plain reference.  With
``use_control()`` the reference itself, in TF32, takes the program's
place: the run that has to come out not correct.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench.lib import data
from bench.lib.checks import WORST, ann_numbers, cp_numbers, worst
from bench.lib.profiling import SpanSlice, profile_slice
from bench.reference.pmlsh import AnnReference, CpReference, projection_from_seed

__all__ = ["KINDS", "BatchSearch", "CpSearch", "ServeOpen", "percentile"]


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value with at least
    p % of the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(int(math.ceil(p / 100.0 * v.size)) - 1, 0)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Reply:
    """An answer in the facade's shape, as the control gives it."""

    def __init__(self, indices, distances):
        self.indices = np.asarray(indices, dtype=np.int32)
        self.distances = np.asarray(distances, dtype=np.float32)

    @property
    def pairs(self):
        return self.indices


class _Kind:
    """What the three kinds share: sizes from the configuration, the
    traffic's parameters, the seed, the device and the record."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        ds, ix = config["dataset"], config["index"]
        self.n, self.d = int(ds["n"]), int(ds["d"])
        self.m, self.c, self.cp_c = int(ix["m"]), float(ix["c"]), float(ix["cp_c"])
        self.index_seed = int(ix["index_seed"])
        self.attempted = 0
        self.failed = 0
        self._ref = None

    #: calls a closed-loop window makes at least, however long they take
    min_calls = 1
    #: seconds past the window's close that an open loop waits for answers
    grace_s = 60.0

    def make_rows(self) -> torch.Tensor:
        """The collection: rows drawn by the seed from the configuration's
        mixture."""
        ds = self.config["dataset"]
        return data.clustered_twin(self.n, self.d, int(ds["clusters"]), int(ds["active"]),
                                   int(ds["mixture_seed"]), self.seed, self.device)

    def make_queries(self, count: int) -> np.ndarray:
        """The pool of queries: jittered rows of the collection, from the seed."""
        return data.jittered_queries(self.rows, count, self.seed).cpu().numpy()

    def projection(self) -> torch.Tensor:
        """A, as an index built with the configuration's ``index_seed`` draws it."""
        return projection_from_seed(self.d, self.m, self.index_seed).to(self.device)

    def limits(self) -> dict:
        return dict(self.traffic["limits"])

    def judged(self, numbers: dict) -> dict:
        """{name: (value, limit)} for the numbers this kind compares.  A
        limit given as a string names the index parameter that states it
        (``"cp_c"``: the approximation ratio the configuration guarantees)."""
        out = {}
        for name, lim in self.limits().items():
            if isinstance(lim, str):
                lim = self.config["index"][lim]
            out[name] = (float(numbers[name]), float(lim))
        return out


class BatchSearch(_Kind):
    entry = "FlatBackend.search"

    def setup(self) -> None:
        from repro_torch.index import FlatBackend, IndexConfig

        tr = self.traffic
        self.B, self.k, self.P = int(tr["batch"]), int(tr["k"]), int(tr["pool"])
        if self.P % self.B:
            raise ValueError(f"pool {self.P} is not a multiple of batch {self.B}")
        self.rows = self.make_rows()
        self.a = self.projection()
        self.queries = self.make_queries(self.P)
        self.reseed(self.seed)
        cfg = IndexConfig(backend="flat", c=self.c, m=self.m, default_k=self.k)
        self.index = FlatBackend.from_arrays(self.rows, self.a.cpu().numpy(), config=cfg,
                                             device=self.device)
        self.search = self.index.search
        for _ in range(2):  # the kernels' first launches, then a steady call
            self.search(self.batch(0), k=self.k)
        _sync(self.device)

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: the pool's batches in its order, from the
        first call."""
        self.seed = int(seed)
        order = np.random.default_rng(data.sub_seed(seed, "batches")).permutation(
            self.P // self.B)
        self.pool = self.queries.reshape(-1, self.B, self.d)[order].reshape(self.P, self.d)
        self.next_call = 0

    def use_control(self) -> None:
        ref = AnnReference(self.rows, self.a, c=self.c, precision="tf32")

        def search(q, k):
            ids, dist = ref.answer(torch.from_numpy(q).to(self.device), k)
            return _Reply(ids.cpu().numpy(), dist.cpu().numpy())

        self.search = search

    def batch(self, i: int) -> np.ndarray:
        s = (i * self.B) % self.P
        return self.pool[s:s + self.B]

    def window(self, seconds: float) -> dict:
        search, k = self.search, self.k
        self.log = log = []
        i, t0 = 0, time.perf_counter()
        end = t0 + seconds
        while True:
            res = search(self.batch(i), k=k)
            log.append((res.indices, res.distances))
            i += 1
            t = time.perf_counter()
            if t >= end and i >= self.min_calls:
                break
        self.next_call = i
        self.attempted = i * self.B
        return {"qps": i * self.B / (t - t0), "calls": i, "window_s": t - t0}

    def _calls(self, count: int):
        from torch.profiler import record_function

        first = self.next_call
        for i in range(first, first + count):
            with record_function("bench.search"):
                self.search(self.batch(i), k=self.k)
        self.next_call = first + count
        return count, [{"call": i, "B": self.B, "k": self.k}
                       for i in range(first, first + count)]

    def span_slice(self) -> SpanSlice:
        from repro_torch.obs import trace as otrace

        count = int(self.traffic["trace_calls"])
        with otrace.trace() as tr:
            t0 = time.perf_counter()
            self._calls(count)
            t1 = time.perf_counter()
        return SpanSlice(tr.spans, t0, t1, calls=count, answered=count * self.B)

    def profile_slice(self):
        return profile_slice(lambda: self._calls(int(self.traffic["trace_calls"])),
                             self.device)

    def release(self) -> None:
        self.index = self.search = None

    def reference(self) -> AnnReference:
        if self._ref is None:
            self._ref = AnnReference(self.rows, self.a, c=self.c)
        return self._ref

    def query(self, call: int) -> torch.Tensor:
        return torch.from_numpy(self.batch(call)).to(self.device)

    def check(self) -> dict:
        ref = self.reference()
        rng = np.random.default_rng(data.sub_seed(self.seed, "check"))
        count = min(len(self.log), int(self.traffic["check_calls"]))
        picks = sorted(rng.choice(len(self.log), size=count, replace=False).tolist())
        missed = slots = 0
        err = 0.0
        for i in picks:
            ids, dist = self.log[i]
            got = ann_numbers(ref, self.query(i), ids, dist, self.k)
            missed += got["missed"]
            slots += got["slots"]
            err = worst(err, got["dist_err"])
        self.checked = count
        return self.judged({"miss": missed / max(slots, 1), "dist_err": err})


class CpSearch(_Kind):
    entry = "FlatBackend.cp_search"

    def setup(self) -> None:
        from repro_torch.index import FlatBackend, IndexConfig

        tr = self.traffic
        self.choices = [int(k) for k in tr["k_choices"]]
        self.reseed(self.seed)
        self.rows = self.make_rows()
        self.a = self.projection()
        cfg = IndexConfig(backend="flat", cp_c=self.cp_c, m=self.m)
        self.index = FlatBackend.from_arrays(self.rows, self.a.cpu().numpy(), config=cfg,
                                             device=self.device)
        self.cp = self.index.cp_search
        for k in self.choices:
            self.cp(k)
        _sync(self.device)

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: its order of k, from the first call."""
        self.seed = int(seed)
        self.ks = data.fixed_order(self.choices, int(self.traffic["cycle"]), self.seed, "k")
        self.next_call = 0

    def use_control(self) -> None:
        ref = CpReference(self.rows, self.a[:, 0], c=self.cp_c, m=self.m, precision="tf32")

        def cp(k):
            pairs, dist = ref.nearest(k)
            return _Reply(pairs.cpu().numpy(), dist.cpu().numpy())

        self.cp = cp

    def k_of(self, call: int) -> int:
        return int(self.ks[call % len(self.ks)])

    def window(self, seconds: float) -> dict:
        cp = self.cp
        self.log = log = []
        i, t0 = 0, time.perf_counter()
        end = t0 + seconds
        while True:
            k = self.k_of(i)
            res = cp(k)
            log.append((k, res.pairs, res.distances))
            i += 1
            t = time.perf_counter()
            if t >= end and i >= self.min_calls:
                break
        self.next_call = i
        self.attempted = i
        return {"cp_ms": (t - t0) * 1e3 / i, "calls": i, "window_s": t - t0}

    def _calls(self, count: int):
        from torch.profiler import record_function

        first = self.next_call
        info = []
        for i in range(first, first + count):
            k = self.k_of(i)
            with record_function("bench.cp_search"):
                self.cp(k)
            info.append({"call": i, "k": k})
        self.next_call = first + count
        return count, info

    def span_slice(self) -> SpanSlice:
        from repro_torch.obs import trace as otrace

        count = int(self.traffic["trace_calls"])
        with otrace.trace() as tr:
            t0 = time.perf_counter()
            self._calls(count)
            t1 = time.perf_counter()
        return SpanSlice(tr.spans, t0, t1, calls=count, answered=count)

    def profile_slice(self):
        return profile_slice(lambda: self._calls(int(self.traffic["trace_calls"])),
                             self.device)

    def release(self) -> None:
        self.index = self.cp = None

    def reference(self) -> CpReference:
        if self._ref is None:
            self._ref = CpReference(self.rows, self.a[:, 0], c=self.cp_c, m=self.m)
            self._nearest = {k: self._ref.nearest(k) for k in self.choices}
        return self._ref

    def reference_radius(self, k: int) -> float:
        """The k-th smallest pair distance."""
        self.reference()
        return float(self._nearest[k][1].max())

    def check(self) -> dict:
        """Every answer of the window (each distinct one once) against the
        k nearest pairs: the worst ratio and distance error of any answer,
        and the share of the exact pairs the distinct answers left out,
        pooled over them."""
        ref = self.reference()
        seen: dict = {}
        for k, pairs, dist in self.log:
            key = (k, np.asarray(pairs).tobytes(), np.asarray(dist).tobytes())
            if key not in seen:
                seen[key] = cp_numbers(ref, pairs, dist, k, self._nearest[k])
        self.checked = len(self.log)
        self.distinct = len(seen)
        self.found = min(v["found"] for v in seen.values())
        wanted = sum(v["wanted"] for v in seen.values())
        missed = sum(v["wanted"] * (1.0 - v["found"]) for v in seen.values())
        return self.judged({"ratio": worst(*(v["ratio"] for v in seen.values())),
                            "dist_err": worst(*(v["dist_err"] for v in seen.values())),
                            "pair_miss": missed / max(wanted, 1)})


# response status codes of the serve kind's record
PENDING, OK, DEGRADED, SHED, FAILED = 0, 1, 2, 3, 4
_STATUS = {"ok": OK, "shed": SHED, "failed": FAILED, "rejected": FAILED}


class ServeOpen(_Kind):
    entry = "RequestScheduler over make_retrieval_step"

    def setup(self) -> None:
        from repro_torch.index import IndexConfig
        from repro_torch.serve import ServeConfig
        from repro_torch.serve.batcher import pow2_ceil
        from repro_torch.serve.serve_step import make_retrieval_step

        tr = self.traffic
        self.k, self.P = int(tr["k"]), int(tr["pool"])
        self.rate = float(tr["rate_qps"])
        self.rows = self.make_rows()
        keys = self.rows.cpu().numpy()
        self.step, _ = make_retrieval_step(
            keys, np.arange(self.n, dtype=np.int64), k=self.k, device=self.device,
            index_config=IndexConfig(backend="flat", c=self.c, m=self.m,
                                     seed=self.index_seed))
        del keys
        self.serve_config = ServeConfig()
        self.k_pad = pow2_ceil(self.k)
        self.queries = self.make_queries(self.P)
        self.reseed(self.seed)
        b = 1
        while b <= self.serve_config.b_max:  # every flush width the palette has
            self.step.index.search(self.pool[:b], k=self.k_pad)
            b *= 2
        _sync(self.device)

    def reseed(self, seed: int) -> None:
        """The traffic of ``seed``: the pool's queries and the gaps in its
        order, into a fresh scheduler, from the first request."""
        from repro_torch.serve import RequestScheduler

        self.seed = int(seed)
        order = np.random.default_rng(data.sub_seed(seed, "requests")).permutation(self.P)
        self.pool = self.queries[order]
        self.set_rate(self.rate)
        self.sched = RequestScheduler(self.step, config=self.serve_config)
        self.next_request = 0

    def set_rate(self, rate: float) -> None:
        """Arrivals at ``rate`` a second: one set of gaps for every seed
        (from the traffic's own ``gap_seed``), its mean exactly 1/rate, in
        an order drawn from the run's seed."""
        self.rate = float(rate)
        gaps = np.random.default_rng(int(self.traffic["gap_seed"])).exponential(
            1.0, int(self.traffic["gap_count"]))
        gaps *= 1.0 / (self.rate * gaps.mean())
        self.gaps = gaps[np.random.default_rng(data.sub_seed(self.seed, "gaps"))
                         .permutation(gaps.size)]

    def use_control(self) -> None:
        from repro_torch.index import SearchResult

        ref = AnnReference(self.rows, self.projection(), c=self.c, precision="tf32")
        index = self.step.index

        def search(q, k=None):
            ids, dist = ref.answer(torch.from_numpy(np.asarray(q)).to(self.device), k)
            return SearchResult(ids.cpu().numpy(), dist.cpu().numpy())

        index.search = search

    def _loop(self, seconds: float, keep: set | None = None):
        """Offer the arrivals due in the next ``seconds`` and serve them to
        the end.  Returns each request's due and done times and status, the
        responses of the requests in ``keep`` (None where never answered),
        and the window's start and end.  ``self.sched_s`` is left holding
        the host seconds spent inside the scheduler's calls that did work:
        every ``submit`` and every ``pump`` that flushed."""
        sched, k = self.sched, self.k
        submit, pump, clock = sched.submit, sched.pump, time.perf_counter
        G, pool, P = self.gaps.size, self.pool, self.P
        first = self.next_request
        cap = int(self.rate * seconds * 1.5) + 64
        due = np.full(cap, np.nan)
        done = np.full(cap, np.nan)
        status = np.zeros(cap, np.int8)
        kept: dict[int, object] = {}
        open_: dict[int, object] = {}
        lateness = sched_s = 0.0

        def collect(now):
            for i in [i for i, t in open_.items() if t.done]:
                record(i, open_.pop(i), now)

        def record(i, ticket, now):
            resp = ticket.result()
            done[i] = now
            status[i] = (DEGRADED if resp.status == "ok" and resp.degraded
                         else _STATUS.get(resp.status, FAILED))
            if keep is not None and (first + i) in keep:
                kept[first + i] = resp

        t0 = clock()
        end = t0 + seconds
        nxt, i = t0 + self.gaps[(first) % G], 0
        while True:
            now = clock()
            if now >= end:
                break
            while nxt <= now and i < cap:
                depth = sched.queue_depth
                before = clock()
                ticket = submit(pool[(first + i) % P], k)
                after = clock()
                sched_s += after - before
                lateness = max(lateness, now - nxt)
                due[i] = nxt
                if ticket.done:  # a cache hit, a shed, or the flush it filled
                    record(i, ticket, after)
                else:
                    open_[i] = ticket
                if sched.queue_depth <= depth:  # this submit flushed
                    collect(after)
                i += 1
                nxt += self.gaps[(first + i) % G]
            depth = sched.queue_depth
            before = clock()
            pump()
            if sched.queue_depth < depth:
                after = clock()
                sched_s += after - before
                collect(after)
        # serve what is due to its end: a minute past the close at most
        stop = clock() + self.grace_s
        while open_ and clock() < stop:
            depth = sched.queue_depth
            before = clock()
            pump()
            if sched.queue_depth < depth:
                after = clock()
                sched_s += after - before
                collect(after)
        if open_:
            sched.drain()
            collect(clock())
        for i in open_:  # never answered: kept as such
            if keep is not None and (first + i) in keep:
                kept[first + i] = None
        self.next_request = first + i
        self.lateness_s = lateness
        self.sched_s = sched_s
        return due[:i], done[:i], status[:i], kept, t0, end

    def window(self, seconds: float) -> dict:
        expect = int(self.rate * seconds)
        rng = np.random.default_rng(data.sub_seed(self.seed, "check"))
        count = min(int(self.traffic["check_requests"]), max(expect - 1, 1))
        keep = set(rng.choice(max(expect, 1), size=count, replace=False).tolist())
        due, done, status, kept, t0, end = self._loop(seconds, keep)
        lat = np.where(status == OK, done - due, np.inf)
        self.kept, self.status = kept, status
        self.attempted = int(status.size)
        self.failed = int((status != OK).sum())
        return {"p95_ms": percentile(lat, 95) * 1e3, "p50_ms": percentile(lat, 50) * 1e3,
                "requests": int(status.size), "answered_qps": int((status == OK).sum())
                / (end - t0), "lateness_ms": self.lateness_s * 1e3, "window_s": end - t0}

    def span_slice(self) -> SpanSlice:
        from repro_torch.obs import trace as otrace

        seconds = float(self.traffic["trace_seconds"])
        with otrace.trace() as tr:
            due, done, status, _, t0, _ = self._loop(seconds)
            t1 = time.perf_counter()
        return SpanSlice(tr.spans, t0, t1, calls=int(status.size),
                         answered=int((status == OK).sum()), entry_s=self.sched_s)

    def profile_slice(self):
        def run():
            due, done, status, *_ = self._loop(float(self.traffic["trace_seconds"]))
            return int(status.size), [{"requests": int(status.size)}]

        return profile_slice(run, self.device)

    def release(self) -> None:
        self.sched = self.step = None

    def reference(self) -> AnnReference:
        if self._ref is None:
            self._ref = AnnReference(self.rows, self.projection(), c=self.c)
        return self._ref

    def check(self) -> dict:
        """The kept responses against the reference: each searched at the
        palette's k_pad (so with T = beta n + k_pad) and sliced to k, its
        payloads the values of its ids (values = arange(n)), its mask all
        valid, its distances those of its result.  A kept request that was
        not answered ok (shed, degraded, failed, never answered) misses all
        of its k answers."""
        ref = self.reference()
        T = ref.budget(self.k_pad)
        rids = sorted(self.kept)
        missed = slots = bad = 0
        err = 0.0
        for s in range(0, len(rids), 64):
            block = rids[s:s + 64]
            resps = [self.kept[r] for r in block]
            ok = [r for r, x in zip(block, resps)
                  if x is not None and x.status == "ok" and not x.degraded]
            bad += len(block) - len(ok)
            if not ok:
                continue
            q = torch.from_numpy(np.stack([self.pool[r % self.P] for r in ok])).to(self.device)
            good = [self.kept[r] for r in ok]
            shaped = all(x.result.indices.shape == (1, self.k) and x.payloads.shape == (1, self.k)
                         for x in good)
            if not shaped:
                bad += len(ok)
                continue
            ids = np.concatenate([x.result.indices for x in good])
            dist = np.concatenate([x.result.distances for x in good])
            for x in good:
                if not (np.array_equal(x.payloads, x.result.indices)
                        and bool(x.valid.all())
                        and np.array_equal(x.distances, x.result.distances)):
                    bad += 1
            got = ann_numbers(ref, q, ids, dist, self.k, T)
            missed += got["missed"]
            slots += got["slots"]
            err = worst(err, got["dist_err"])
        self.checked = len(rids)
        numbers = {"miss": (missed + bad * self.k) / max(slots + bad * self.k, 1),
                   "dist_err": err if slots else WORST}
        return self.judged(numbers)


KINDS = {"batch_search": BatchSearch, "cp_search": CpSearch, "serve_open": ServeOpen}
