"""``examples/torch_quickstart.py`` held to ``examples/quickstart.py``:
given the reference's draws, the port's tour prints the reference's
lines, line for line.

The reference's ``main`` runs with its ``build_index`` wrapped to keep
each index it builds; the port's ``run("cpu", build=...)`` then carries
each across in the same order — the pmtree indexes with the JAX A and
projection (``PMTreeBackend.from_arrays``, which builds the same trees),
``flat`` with its A and projection (``FlatBackend.from_arrays``) — and
builds the exact ``nlj`` join, which draws nothing, itself.  No line
differs by a documented deviation (ROADMAP §C) at these sizes."""
import importlib.util
import pathlib

import numpy as np

from repro.index import IndexConfig as JaxConfig
from repro_torch.index import FlatBackend, IndexConfig, PMTreeBackend, build_index

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(ji, data, config, device):
    a = np.asarray(ji.impl.family.a)
    if config.backend == "pmtree":
        return PMTreeBackend.from_arrays(data, a, np.asarray(ji.impl.projected), config,
                                         device=device)
    assert config.backend == "flat"
    return FlatBackend.from_arrays(data, a, np.asarray(ji.impl.projected), config,
                                   device=device)


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    ref = load("examples/quickstart.py", "jax_quickstart")
    built, original = [], ref.build_index

    def recording(data, config=None, **overrides):
        index = original(data, config, **overrides)
        built.append((np.array(data, copy=True), index))
        return index

    monkeypatch.setattr(ref, "build_index", recording)
    ref.main()
    want = capsys.readouterr().out.splitlines()
    assert len(built) == 5

    twin = load("examples/torch_quickstart.py", "torch_quickstart")
    order = iter(built)

    def build(data, config=None, *, device, **overrides):
        config = (config or IndexConfig())
        if overrides:
            config = config.replace(**overrides)
        jdata, ji = next(order)
        np.testing.assert_array_equal(data, jdata)
        assert ji.config == JaxConfig(**{f: getattr(config, f) for f in (
            "backend", "c", "cp_c", "m", "seed", "default_k", "options")})
        if config.backend == "nlj":
            return build_index(data, config, device=device)
        return _carry(ji, data, config, device)

    lines = twin.run("cpu", build=build)
    assert next(order, None) is None
    got = "\n".join(lines).splitlines()
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g == w


def test_quickstart_main_prints_its_run(monkeypatch, capsys):
    twin = load("examples/torch_quickstart.py", "torch_quickstart_main")
    monkeypatch.setattr(twin, "run", lambda device, build=None: [f"on {device}", "done"])
    assert twin.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == "on cpu\ndone\n"
