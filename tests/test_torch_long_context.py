"""``examples/torch_long_context.py`` held to ``examples/long_context.py``.

The reference's ``run(cfg, label, ctx_len=1024)`` runs with its
``jax.jit`` wrapped to record each decode step's input tokens and
logits; the twin's ``run`` then takes the reference's parameters
(``lm_params_from_numpy``) at the same sizes, in float32, for dense
attention and for PM-LSH at T = 256, m = 16.  The 9 steps' tokens are
the reference's, the first and the last step's logits within 1e-4 of
the largest, and the dense↔LSH correlation the reference's.  The cache
is 1,024 rows here for time, in ``main`` too; ``chip_smoke.py`` runs
the example's 8,192."""
import functools
import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_module as jax_model_module
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import model_module

ROOT = pathlib.Path(__file__).resolve().parents[1]
CTX = 1024
LOGIT_TOL = 1e-4  # of the largest logit
LINE_TAIL = re.compile(r"^ *(.+): +[0-9.]+ ms/token (\(.*\))$")
CONFIGS = {"dense attention": dict(lsh_attention=False),
           "PM-LSH retrieval attn": dict(lsh_attention=True, lsh_topk=256, lsh_m=16)}


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class RecordingJax:
    """The reference module's ``jax``, its ``jit`` recording every call's
    input tokens and output logits."""

    random, tree = jax.random, jax.tree

    def __init__(self):
        self.steps = []

    def jit(self, fn):
        compiled = jax.jit(fn)

        def step(params, caches, batch):
            logits, caches = compiled(params, caches, batch)
            self.steps.append((np.asarray(batch["tokens"]), np.asarray(logits)))
            return logits, caches

        return step


def _within(got: torch.Tensor, want: np.ndarray) -> None:
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_TOL * float(np.abs(want).max()), err


def test_long_context_decodes_the_reference_tokens_in_float32(capsys, monkeypatch):
    ref = load("examples/long_context.py", "jax_long_context")
    twin = load("examples/torch_long_context.py", "torch_long_context")
    rec = RecordingJax()
    monkeypatch.setattr(ref, "jax", rec)
    jbase = ref.get_smoke_config("yi_6b").replace(dtype=jnp.float32)
    tbase = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    last = {}
    for label, over in CONFIGS.items():
        jcfg, tcfg = jbase.replace(**over), tbase.replace(**over)
        rec.steps.clear()
        want_last = np.asarray(ref.run(jcfg, label, ctx_len=CTX))
        want_line = capsys.readouterr().out.rstrip("\n")
        jparams = jax_model_module(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        out = twin.run(tcfg, label, ctx_len=CTX, device="cpu", params=params)
        assert capsys.readouterr().out == out["line"] + "\n"
        assert LINE_TAIL.match(out["line"]).groups() == LINE_TAIL.match(want_line).groups()
        assert len(rec.steps) == 9 and len(out["step_ms"]) == 8
        np.testing.assert_array_equal(out["tokens"], [int(t[0, 0]) for t, _ in rec.steps])
        np.testing.assert_array_equal(rec.steps[-1][1], want_last)
        _within(out["first"], rec.steps[0][1])
        _within(out["last"], want_last)
        last[label] = (out["last"], want_last)
    (d_got, d_want), (l_got, l_want) = last.values()
    want_corr = np.corrcoef(d_want.ravel(), l_want.ravel())[0, 1]
    assert twin.correlation(d_got, l_got) == pytest.approx(want_corr, abs=1e-3)


def test_long_context_main_on_the_cpu(capsys, monkeypatch):
    twin = load("examples/torch_long_context.py", "torch_long_context_main")
    monkeypatch.setattr(twin, "run", functools.partial(twin.run, ctx_len=CTX))
    assert twin.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert lines[0].endswith(f"(cache {CTX} × 2 kv-heads, budget dense)")
    assert lines[1].endswith(f"(cache {CTX} × 2 kv-heads, budget 256)")
    corr = float(re.match(r"dense↔LSH logit correlation: ([0-9.-]+) ", lines[2]).group(1))
    assert corr >= 0.995  # every key fits the budget: the same weights answer alike


def test_one_seed_draws_the_same_weights_with_pm_lsh_on_and_off():
    """The reference draws each layer's ``lsh_a`` from its own folded
    key, so one seed gives a dense and a PM-LSH config the same weights
    (the example's correlation of 1.000 rests on it); the port draws
    ``lsh_a`` from a stream of its own (``layers.lsh_generator``)."""
    base = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    dense, lsh = (model_module(base).init_params(base.replace(**over), 3, device="cpu")
                  for over in CONFIGS.values())
    got = dict(lsh.named_parameters())
    for name, p in dense.named_parameters():
        assert torch.equal(got.pop(name), p), name
    assert sorted(got) == [f"blocks.{i}.attn.lsh_a" for i in range(base.n_layers)]
    again = model_module(base).init_params(base.replace(**CONFIGS["PM-LSH retrieval attn"]), 3,
                                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), lsh.parameters()))
