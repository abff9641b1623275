"""Each cell's whole run at a tiny size on the CPU: sound, it comes out
correct; with the timed path broken underneath in each way the cell can
break, or with the TF32 control in the program's place, it does not."""
import dataclasses

import numpy as np
import pytest

CELLS = ["deep1m.ann_b64", "audio.cp_mixk", "deep1m.serve_open"]


def _wrap_search(kind, change):
    """Break the search the cell's window drives: the facade's for the batch
    cell, the index behind the scheduler for the serving cell."""
    target = kind.step.index if hasattr(kind, "step") else kind
    inner = target.search
    state = {}

    def search(q, k=None, **kw):
        res = inner(q, k=k, **kw)
        return change(res, state)

    if hasattr(kind, "step"):
        target.search = search
    else:
        kind.search = search


def _replace(res, indices, distances):
    out = dataclasses.replace(res) if dataclasses.is_dataclass(res) else res
    out.indices, out.distances = indices, distances
    return out


def _altered(res, state):
    ids = res.indices.copy()
    ids[:, 0] = (ids[:, 0] + 1) % 1000
    return _replace(res, ids, res.distances.copy())


def _half(res, state):
    """Half of the batch left out: its rows answered with the other half's."""
    ids, dist = res.indices.copy(), res.distances.copy()
    h = max(ids.shape[0] // 2, 1)
    ids[h:] = ids[: ids.shape[0] - h]
    dist[h:] = dist[: dist.shape[0] - h]
    return _replace(res, ids, dist)


def _stale(res, state):
    """The state returned unchanged: every call answers as the first did."""
    first = state.setdefault("first", res)
    shape = res.indices.shape
    return _replace(res, np.resize(first.indices, shape), np.resize(first.distances, shape))


def _wrap_cp(kind, change):
    inner = kind.cp
    state = {}
    kind.cp = lambda k: change(inner(k), state)


def _cp_altered(res, state):
    pairs = res.pairs.copy()
    pairs[-1] = (0, 1) if tuple(pairs[-1]) != (0, 1) else (0, 2)
    res.pairs = pairs
    return res


def _cp_half(res, state):
    h = max(len(res.pairs) // 2, 1)
    res.pairs, res.distances = res.pairs[:h].copy(), res.distances[:h].copy()
    return res


def _cp_stale(res, state):
    first = state.setdefault("first", res)
    return first


SEARCH_FAULTS = {"altered": _altered, "half": _half, "stale": _stale}
CP_FAULTS = {"altered": _cp_altered, "half": _cp_half, "stale": _cp_stale}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_run, cell):
    result, notes = tiny_run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_spans(tiny_run, cell):
    result, _ = tiny_run(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    # on the CPU the spans are there; the device metrics have nothing to read
    assert result["metrics"]
    assert all(not k.startswith(("idle_share", "pipeline")) for k in result["metrics"])


@pytest.mark.parametrize("fault", sorted(SEARCH_FAULTS))
@pytest.mark.parametrize("cell", ["deep1m.ann_b64", "deep1m.serve_open"])
def test_broken_search_is_not_correct(tiny_run, cell, fault):
    # the serving cell's window long enough for several flushes
    result, _ = tiny_run(cell, seconds=0.3 if cell == "deep1m.ann_b64" else 1.0,
                         tamper=lambda kind: _wrap_search(kind, SEARCH_FAULTS[fault]))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(CP_FAULTS))
def test_broken_cp_search_is_not_correct(tiny_run, fault):
    # min_calls: enough calls for k to change, which a stale answer misses
    result, _ = tiny_run("audio.cp_mixk",
                         tamper=lambda kind: _wrap_cp(kind, CP_FAULTS[fault]))
    assert not result["correct"], result["checks"]


def test_half_rows_cp_search_is_not_correct(tiny_run):
    """A join over half of the rows: its pairs are real and their distances
    exact, but most of the nearest pairs are missing."""
    from bench.lib.faults import cp_half_rows

    result, _ = tiny_run("audio.cp_mixk", tamper=cp_half_rows)
    assert not result["correct"], result["checks"]
    assert result["checks"]["dist_err"]["value"] <= result["checks"]["dist_err"]["limit"]
    assert result["checks"]["pair_miss"]["value"] > result["checks"]["pair_miss"]["limit"]


class _Dropping(dict):
    """A scheduler's ticket table that loses every other response."""

    def pop(self, key, default=None):
        got = super().pop(key, default)
        return None if key % 2 else got


def test_requests_never_answered_are_not_correct(tiny_run):
    """Half of each flush's responses never delivered: those requests never
    come back, and the kept ones among them miss."""

    def tamper(kind):
        kind.sched._tickets = _Dropping(kind.sched._tickets)

    result, _ = tiny_run("deep1m.serve_open", seconds=1.0, tamper=tamper)
    assert not result["correct"], result["checks"]
    assert result["failed"] > result["attempted"] // 4


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_run, cell):
    """The reference in TF32, in the program's place, fails a limit."""
    result, _ = tiny_run(cell, control=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["dist_err"]["value"] > result["checks"]["dist_err"]["limit"]


def test_percentile_is_nearest_rank():
    from bench.lib.cells import percentile

    v = np.arange(1, 101)
    assert percentile(v, 95) == 95 and percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, np.inf], 50) == 1.0 and percentile([1.0, np.inf], 95) == np.inf
