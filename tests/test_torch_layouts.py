"""The parameter layouts of the ('data', 'model') mesh held to the
reference's tables: ``param_pspecs`` leaf by leaf for all ten
architectures at their published widths, on the production meshes and
three host meshes, with FSDP off and on (the meshes are duck-typed
stand-ins, ``SimpleNamespace(axis_names=..., shape=...)``, which the
reference's rule functions accept); ``opt_state_shardings``' specs against
the reference's on real 8-device meshes in one JAX subprocess;
``make_production_mesh``'s names and sizes; and the per-layer view the
port executes (``layer_layouts``), including the two leaves whose spec
splits the scan-stacked layer dimension: qwen2-moe's shared expert and
xlstm's sLSTM input gate.
"""

import types

import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.configs import get_config as jax_config
from repro.launch import sharding as jsh
from repro.models import model_module as jax_model_module
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_tree
from repro_torch.launch import make_production_mesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import model_module
from repro_torch.train import opt_state_shardings
from test_torch_lm_shard import run_jax

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "2x4": (("data", "model"), (2, 4)),
          "8x1": (("data", "model"), (8, 1))}
HOST = ("4x2", "2x4", "8x1")


def mesh_like(name):
    names, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def specs_tuple(tree):
    """The reference's spec tree with each PartitionSpec as a tuple."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: specs_tuple(v) for k, v in tree.items()}
    return type(tree)(specs_tuple(v) for v in tree)


_TREES = {}


def trees(arch: str):
    """(the reference's abstract parameters, the port's stacked meta tree)."""
    if arch not in _TREES:
        jc, tc = jax_config(arch), get_config(arch)
        _TREES[arch] = (jax_model_module(jc).abstract_params(jc),
                        lm_params_to_tree(tc, model_module(tc).abstract_params(tc)))
    return _TREES[arch]


def flat(tree, path=()):
    """{path: spec} of a spec tree (an empty tuple is an empty container:
    no parameter has a spec of rank 0)."""
    if tree == ():
        return {}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (key,)).items()}
    if isinstance(tree, tuple) and not all(e is None or isinstance(e, (str, tuple))
                                           for e in tree):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat(sub, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jcb.list_archs())
def test_param_pspecs_equal_the_reference(arch, mesh, fsdp):
    m = mesh_like(mesh)
    jtree, ttree = trees(arch)
    want = specs_tuple(jsh.param_pspecs(jtree, m, fsdp=fsdp))
    got = tsh.param_pspecs(ttree, m, fsdp=fsdp)
    assert got == want
    # the per-layer view: each of the port's leaves is its stacked leaf's
    # spec with the layer entry taken off (and kept as ``layer_axes``)
    from repro.models.transformer import layer_plan

    cfg = get_config(arch)
    stacked = flat(got)
    layouts = tsh.layer_layouts(cfg, m, fsdp=fsdp)
    assert set(layouts) == {n for n, _ in model_module(cfg).abstract_params(cfg)
                            .named_parameters()}
    for name, lay in layouts.items():
        head, *rest = name.split(".")
        if head in ("encoder", "decoder"):
            want = stacked["/".join([head] + rest[1:])]
        elif head == "blocks":
            unit, n_units, _ = layer_plan(jax_config(arch))
            i = int(rest[0])
            if i < n_units * len(unit):
                want = stacked["/".join(["unit", str(i % len(unit))] + rest[1:])]
            else:
                want = (None,) + stacked["/".join(["rest", str(i - n_units * len(unit))]
                                                   + rest[1:])]
        else:
            assert stacked[name] == lay.spec and lay.layer_axes is None
            continue
        assert (lay.layer_axes,) + lay.spec == want, name


def test_the_stacked_dimension_leaves():
    """The layer dimension split over 'model' (``_param_rule`` picks the
    rank-3 rule by ``ndim >= 3``, stacked dimension included)."""
    m = mesh_like("4x2")
    for arch, leaf, n in (("qwen2_moe_a2_7b", "moe.shared.w_gate", 24),
                          ("xlstm_125m", "slstm.w_i", 6)):
        jtree, ttree = trees(arch)
        want = specs_tuple(jsh.param_pspecs(jtree, m))
        got = tsh.param_pspecs(ttree, m)
        if arch == "qwen2_moe_a2_7b":
            w, g = want["unit"][0]["moe"]["shared"]["w_gate"], got["unit"][0]["moe"]["shared"][
                "w_gate"]
        else:
            w, g = want["unit"][1]["slstm"]["w_i"], got["unit"][1]["slstm"]["w_i"]
        assert w == g == ("model", None, None)
        layouts = tsh.layer_layouts(get_config(arch), m)
        unit = 1 if arch == "qwen2_moe_a2_7b" else 2
        for u in range(n):
            i = u * unit + (0 if unit == 1 else 1)
            lay = layouts[f"blocks.{i}.{leaf}"]
            assert lay.layer_axes == "model" and lay.spec == (None, None)
            assert lay.owner == u // (n // 2)  # layers [s·n/2, (s+1)·n/2) on shard s
            assert lay.local_shape(m) == lay.shape


def test_a_column_block_can_cut_a_head():
    """yi-6b at (16, 16): wk / wv (4096, 4·128) split into 32-column
    blocks, a quarter head each; recurrentgemma's MQA wk halved at 2."""
    lay = tsh.layer_layouts(get_config("yi_6b"), mesh_like("16x16"))["blocks.0.attn.wk"]
    assert lay.spec == (None, "model") and lay.local_shape(mesh_like("16x16")) == (4096, 32)
    rg = tsh.layer_layouts(get_config("recurrentgemma_9b"), mesh_like("4x2"))
    assert rg["blocks.2.attn.wk"].local_shape(mesh_like("4x2")) == (4096, 128)
    assert rg["blocks.0.rec.w_a"].spec == ("model", None, None)


def test_local_block_cuts_the_spec():
    m = mesh_like("2x4")
    lay = tsh.LeafLayout("w", (8, 12), ("data", "model"))
    t = torch.arange(96.0).reshape(8, 12)
    assert torch.equal(tsh.local_block(t, lay, m, (1, 2)), t[4:8, 6:9])
    held = tsh.LeafLayout("w", (8, 12), (None, None), "model", 3)
    assert tsh.local_block(t, held, m, (0, 3)).shape == (8, 12)
    assert tsh.local_block(t, held, m, (0, 1)).numel() == 0


def test_production_mesh_names_and_sizes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model") and one.shape == {"data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    # the tables read it as they read the reference's mesh
    lay = tsh.layer_layouts(get_config("yi_6b"), two, fsdp=True)["blocks.0.mlp.w_down"]
    assert lay.spec == ("model", ("pod", "data"))


_JAX = r"""
import json, numpy as np, jax
from repro.compat import make_mesh
from repro.configs import get_config
from repro.models import model_module
from repro.train.train_step import opt_state_shardings
out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    ap = model_module(cfg).abstract_params(cfg)
    for shape in SHAPES:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for fsdp in (False, True):
            sh = opt_state_shardings(ap, mesh, fsdp=fsdp)
            rows = {}
            for part in ("mu", "nu"):
                for path, s in jax.tree_util.tree_flatten_with_path(sh[part])[0]:
                    key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
                    rows[part + ":" + key] = [e if e is None or isinstance(e, str) else list(e)
                                              for e in s.spec]
            rows["step"] = list(sh["step"].spec)
            out[f"{arch}|{shape[0]}x{shape[1]}|{fsdp}"] = np.array(json.dumps(rows))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def jax_opt_specs(tmp_path_factory):
    return run_jax(_JAX, {"unused": np.zeros(1)}, tmp_path_factory.mktemp("jax_layouts"),
                   ARCHS=list(jcb.list_archs()), SHAPES=[MESHES[n][1] for n in HOST])


def _listed(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


@pytest.mark.parametrize("mesh", HOST)
def test_opt_state_shardings_equal_the_reference(jax_opt_specs, mesh):
    import json

    m = mesh_like(mesh)
    for arch in jcb.list_archs():
        ttree = trees(arch)[1]
        for fsdp in (False, True):
            want = json.loads(str(jax_opt_specs[f"{arch}|{mesh}|{fsdp}"]))
            got = opt_state_shardings(ttree, m, fsdp=fsdp)
            rows = {f"{part}:{k}": _listed(v) for part in ("mu", "nu")
                    for k, v in flat(got[part]).items()}
            rows["step"] = list(got["step"])
            # the reference's NamedSharding drops trailing Nones
            trimmed = {k: v[:max([i + 1 for i, e in enumerate(v) if e is not None] or [0])]
                       for k, v in rows.items()}
            want = {k: v[:max([i + 1 for i, e in enumerate(v) if e is not None] or [0])]
                    for k, v in want.items()}
            assert trimmed == want, (arch, fsdp)
