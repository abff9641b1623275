"""``examples/torch_knn_serving.py`` held to ``examples/knn_serving.py``.

In float32, given the reference's parameters (``init_params(cfg,
PRNGKey(0))`` carried across by ``lm_params_from_numpy``) and its
streaming index's projection (the ``repro.core.hashing`` family of the
index's seed, handed to ``StreamingIndex.from_arrays`` through a patched
``build_index``), the port prints the reference's lines: the datastore,
the 8 retrieved tokens, both argmax lines and the grown datastore with
its ``StreamingIndex`` repr; the distances, printed to 3 decimals, agree
within 2e-3.  The example's own dtype, bfloat16, runs through ``main``
on the CPU: the query's own key comes back first."""
import ast
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.hashing import ProjectionFamily
from repro.models import model_module as jax_model_module
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serve import serve_step
from repro_torch.stream import StreamingIndex

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIST_TOL = 2e-3
RETRIEVED = re.compile(r"retrieved next-tokens (\[.*\]) \(distances (\[.*\])\)$")


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _retrieved(line: str) -> tuple[list, np.ndarray]:
    tokens, dists = RETRIEVED.match(line).groups()
    return ast.literal_eval(tokens), np.array(ast.literal_eval(dists))


def test_knn_serving_prints_the_reference_lines_in_float32(capsys, monkeypatch):
    ref = load("examples/knn_serving.py", "jax_knn_serving")
    smoke = ref.get_smoke_config
    monkeypatch.setattr(ref, "get_smoke_config",
                        lambda name: smoke(name).replace(dtype=jnp.float32))
    ref.main()
    want = capsys.readouterr().out.splitlines()

    jcfg = smoke("yi_6b").replace(lsh_attention=False, dtype=jnp.float32)
    jparams = jax_model_module(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("yi_6b").replace(lsh_attention=False, dtype=torch.float32)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    built = []

    def build(keys, config, *, device):
        a = np.asarray(ProjectionFamily.create(keys.shape[1], config.m, seed=config.seed).a)
        built.append(config)
        return StreamingIndex.from_arrays(keys, a, config, device=device)

    monkeypatch.setattr(serve_step, "build_index", build)
    twin = load("examples/torch_knn_serving.py", "torch_knn_serving")
    out = twin.run("cpu", cfg=cfg, params=params)
    got = out["lines"]
    assert capsys.readouterr().out.splitlines() == got
    assert len(built) == 1 and built[0].backend == "streaming"
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == "datastore: 2016 (hidden → next-token) pairs"
    (gt, gd), (wt, wd) = _retrieved(got[1]), _retrieved(want[1])
    assert gt == wt and len(gt) == 8
    np.testing.assert_allclose(gd, wd, rtol=0, atol=DIST_TOL)
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert out["n"] == 2504 and "StreamingIndex(n=2504, d=64," in got[3]
    assert out["ids"][0] == out["row"] == 31 and out["tokens"][0] == out["payload"]


def test_knn_serving_main_in_bfloat16_serves_the_query_s_own_key(capsys, monkeypatch):
    twin = load("examples/torch_knn_serving.py", "torch_knn_serving_main")
    runs, real = [], twin.run
    monkeypatch.setattr(twin, "run", lambda device: runs.append(real(device)) or runs[-1])
    assert twin.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    (out,) = runs
    assert lines == out["lines"] and len(lines) == 4
    assert out["ids"][0] == out["row"] and out["tokens"][0] == out["payload"]
    assert out["distances"][0] <= 1e-3
    assert out["n"] == 2504 and not set(out["ids_after"]) & set(out["evicted"])
