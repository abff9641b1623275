"""``scripts/torch_check_api.py``, the port's twin of
``scripts/check_api.py``, on the CPU: it passes every gate, it sweeps
the reference's backends with the reference's capabilities, and a
backend that answers a wrong distance fails it with a FAIL line.  The
JAX ``check_api.py`` itself is not run here."""
import numpy as np

from repro.index import available_backends as jax_backends
from repro.index import backend_capabilities as jax_capabilities
from repro_torch.index import backend_capabilities, get_backend
from test_torch_quickstart import load


def _swept(out: str) -> dict:
    """{backend: the checks its sweep line names} from the printed lines."""
    swept = {}
    for line in out.splitlines():
        words = line.split()
        if len(words) > 2 and words[0] in ("ok", "FAIL") and words[2].startswith("["):
            checks = line[line.index("[") + 1: line.index("]")]
            swept[words[1]] = {c.split()[0] for c in checks.split(", ")}
    return swept


def test_check_api_passes_every_gate_over_the_reference_backends(capsys):
    assert load("scripts/torch_check_api.py", "torch_check_api").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    swept = _swept(out)
    assert list(swept) == jax_backends()
    for name, checks in swept.items():
        assert backend_capabilities(name) == jax_capabilities(name)
        assert checks == set(jax_capabilities(name)) - {"quant"}, name
    for gate in ("quant", "cp", "serve", "quality", "sharded"):
        assert f"  ok   {gate} gate" in out
    assert "emulated>1]" in out
    assert out.splitlines()[-1].startswith("check_api: all 16 backends conform")


def test_a_wrong_distance_fails_check_api(capsys, monkeypatch):
    cls = get_backend("lscan")
    search = cls._search

    def off_by_one(self, q, k):
        res = search(self, q, k)
        res.distances[res.indices >= 0] += np.float32(1.0)
        return res

    monkeypatch.setattr(cls, "_search", off_by_one)
    assert load("scripts/torch_check_api.py", "torch_check_api").main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    fail = [line for line in lines if line.startswith("  FAIL")]
    assert len(fail) == 1 and fail[0].startswith("  FAIL lscan ")
    assert "AssertionError: distance" in fail[0]
    assert lines[-1] == "check_api: FAILED for ['lscan']"
