"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``: the analytic parts equal for every
(arch × shape) cell on both production meshes; the LM steps on meta
parameters; records rendered by the reference's table script.  The
abstract rank's own tests are in ``test_torch_dryrun_rank.py``.

The reference module sets ``XLA_FLAGS`` to 512 host devices when it is
imported: the ``jdr`` fixture imports it only after JAX's backend has
started (so the device count stays 1) and puts the variable back.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib

import pytest

from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr
from repro_torch.launch import make_host_mesh
from repro_torch.models import model_module
from repro_torch.obs.roofline import get_peaks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = [a.replace("_", "-") for a in list_archs()]


@pytest.fixture(scope="module")
def jdr():
    import jax

    jax.devices()  # the backend starts now, with the one CPU device
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    assert len(jax.devices()) == 1 and jax.device_count() == 1
    assert os.environ.get("XLA_FLAGS") == before
    return mod


def meta_mesh(D: int, M: int):
    return make_host_mesh(M, data=D, device="meta")


# ---------------------------------------------------------------------------
# exact parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chips", [256, 512])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_analytic_costs_equal_the_reference(jdr, arch, shape, n_chips):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_config

    jc, tc = jax_config(arch), get_config(arch)
    assert dr.model_flops_for_cell(tc, SHAPES[shape]) == jdr.model_flops_for_cell(
        jc, JSHAPES[shape])
    assert dr.analytic_cell_costs(tc, SHAPES[shape], n_chips) == jdr.analytic_cell_costs(
        jc, JSHAPES[shape], n_chips)


@pytest.mark.parametrize("n_chips", [256, 512])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_roofline_terms_equal_the_reference_under_its_constants(jdr, monkeypatch, shape,
                                                                n_chips):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(dr, name, getattr(jdr, name))
    coll = {"all-gather": 3.0e9, "all-reduce": 1.5e9, "reduce-scatter": 2.0e8,
            "all-to-all": 7.0e7, "collective-permute": 1.1e6}
    for arch in ARCHS:
        cfg = get_config(arch)
        ana = dr.analytic_cell_costs(cfg, SHAPES[shape], n_chips)
        mflops = dr.model_flops_for_cell(cfg, SHAPES[shape])
        for flops, nbytes, c in ((ana["flops_per_chip"], ana["bytes_per_chip"], coll),
                                 (1e15, 1e9, {}), (0.0, 0.0, coll)):
            got = dr.roofline_terms(flops, nbytes, c, n_chips, mflops)
            want = jdr.roofline_terms(flops, nbytes, c, n_chips, mflops)
            assert got == want, (arch, shape)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_skip_equals_the_reference(jdr, arch, mesh):
    """The skip record where the reference skips (whisper-base alone);
    its condition everywhere."""
    from repro.configs import get_config as jax_config

    skips = not jax_config(arch).sub_quadratic
    assert skips == (arch == "whisper-base")
    if skips:
        assert dr.run_cell(arch, "long_500k", mesh) == jdr.run_cell(arch, "long_500k", mesh)
    else:
        assert get_config(arch).sub_quadratic


def test_the_h100_constants_and_the_fsdp_rule():
    assert dr.PEAK_FLOPS == 989e12 and dr.ICI_BW == 450e9
    assert dr.HBM_BW == get_peaks("cuda").peak_bw == 3.35e12
    picked = [a for a in ARCHS if dr.fsdp_rule(get_config(a))]
    assert picked == ["deepseek-67b", "mistral-large-123b"]
    assert dr.production_axes("single") == (16, 16) and dr.production_axes("multi") == (32, 16)


# ---------------------------------------------------------------------------
# the LM steps on meta parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_run_on_meta_parameters(arch):
    """prefill, decode_step and the train step of every family's smoke
    config on the meta device: meta results of the right shapes."""
    from repro_torch.serve.serve_step import make_decode_step, make_prefill
    from repro_torch.train import make_train_step

    cfg = get_smoke_config(arch)
    mod = model_module(cfg)
    mesh = meta_mesh(1, 1)
    B, S, Vp = 2, 16, cfg.padded_vocab()
    specs = tconfigs.input_specs(cfg, InputShape("p", S, B, "prefill"))
    prefill, info = make_prefill(cfg, mesh, batch=B, seq_len=S, max_seq=2 * S)
    logits, caches = prefill(info["abstract_params"], specs)
    assert logits.is_meta and tuple(logits.shape) == (B, 1, Vp)
    decode, info = make_decode_step(cfg, mesh, batch=B, max_seq=2 * S)
    dspecs = tconfigs.input_specs(cfg, InputShape("d", 2 * S, B, "decode"))
    logits, _ = decode(info["abstract_params"], caches, dspecs)
    assert logits.is_meta and tuple(logits.shape) == (B, 1, Vp)
    step, info = make_train_step(cfg, mesh, batch_specs=tconfigs.input_specs(
        cfg, InputShape("t", S, B, "train")))
    params, opt, metrics = step(info["abstract_params"], info["abstract_opt"],
                                tconfigs.input_specs(cfg, InputShape("t", S, B, "train")))
    assert metrics["loss"].is_meta and int(opt["step"].numel()) == 1
    if cfg.family != "encdec":  # the module's own functions, as the fault hit them
        params = mod.abstract_params(cfg)
        logits, caches = mod.prefill(params, specs, cfg, max_seq=2 * S)
        assert all(t.is_meta for c in caches for t in c.values())
        logits, _ = mod.decode_step(params, caches, dspecs, cfg)
        assert tuple(logits.shape) == (B, 1, Vp)
    caches = mod.init_cache(cfg, B, S, device="meta")
    leaves = caches if isinstance(caches, list) else caches["self"] + caches["cross"]
    assert all(t.is_meta for c in leaves for t in c.values())


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


SMALL_SHAPES = {"train_4k": InputShape("train_4k", 64, 32, "train"),
                "prefill_32k": InputShape("prefill_32k", 64, 32, "prefill"),
                "decode_32k": InputShape("decode_32k", 128, 32, "decode"),
                "long_500k": InputShape("long_500k", 1024, 1, "decode")}


def test_records_render_with_the_reference_table_script(jdr, tmp_path, monkeypatch, capsys):
    """A smoke-config record per shape kind on the production mesh,
    through the CLI into a JSONL, carries every key of the reference's
    record and renders with ``scripts/make_experiments_tables.py``."""
    monkeypatch.setattr(tconfigs, "get_config", get_smoke_config)
    monkeypatch.setattr(tconfigs, "SHAPES", SMALL_SHAPES)
    out = tmp_path / "dryrun.jsonl"
    cells = [("yi-6b", s) for s in SMALL_SHAPES] + [("whisper-base", "long_500k"),
                                                     ("xlstm-125m", "long_500k")]
    for arch, shape in cells:
        with pytest.raises(SystemExit) as ex:
            dr.main(["--arch", arch, "--shape", shape, "--mesh", "single", "--out", str(out)])
        assert ex.value.code == 0
    with pytest.raises(SystemExit) as ex:
        dr.main(["--arch", "no-such-arch", "--shape", "train_4k", "--out", str(out)])
    assert ex.value.code == 1
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    capsys.readouterr()
    assert [r["status"] for r in recs] == ["ok"] * 4 + ["skipped", "ok", "error"]
    keys = {"arch", "shape", "mesh", "family", "memory", "collective_counts",
            "collective_bytes", "hlo_flops", "hlo_bytes", "roofline_hlo", "analytic",
            "roofline", "params_total", "params_active", "lower_s", "compile_s", "status"}
    for r in recs[:4] + recs[5:6]:
        assert keys | {"rank", "fsdp"} == set(r)
        assert set(r["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                    "temp_size_in_bytes", "generated_code_size_in_bytes"}
        assert r["rank"] == [0, 0] and r["fsdp"] is False and r["hlo_flops"] > 0
        assert set(r["roofline"]) == set(r["roofline_hlo"]) == set(jdr.roofline_terms(
            1.0, 1.0, {}, 256, 1.0))
    assert recs[4] == jdr.run_cell("whisper-base", "long_500k", "single")
    assert "no_such_arch" in recs[6]["error"] and recs[6]["trace"]
    spec = importlib.util.spec_from_file_location(
        "make_experiments_tables", ROOT / "scripts" / "make_experiments_tables.py")
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    out.write_text("\n".join(json.dumps(r) for r in recs[:6]) + "\n")
    tables.main(str(out))
    text = capsys.readouterr().out
    row = next(line for line in text.splitlines() if line.startswith("| yi-6b | train_4k | ok"))
    assert "MISSING" in row  # the multi mesh was not run
    assert "| whisper-base | long_500k | skipped" in text
    assert sum(line.startswith("| yi-6b |") for line in text.splitlines()) == 8
