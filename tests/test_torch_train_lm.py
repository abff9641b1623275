"""``examples/torch_train_lm.py`` held to ``examples/train_lm.py``.

The reference's ``main`` runs with its ``TrainLoop`` and mesh stubbed,
so its config and header are read without training: ``yi_100m()`` is
that config field by field (the dtype by name), with its parameter count
and header.  Training is held at the smoke width in float32: the
reference's ``TrainLoop`` runs 4 steps checkpointing at 2 and 4, the
step-2 checkpoint alone is handed to the twin's ``run(steps=4)``, which
resumes there; its two losses are the reference's steps 2 and 3 within
1e-5 relative.  ``main`` on the CPU trains the smoke config (the 125M
model's CPU steps take tens of seconds)."""
import dataclasses
import importlib.util
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.train import TrainLoop as JaxTrainLoop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADER = "training yi-100m: 125M params, 300 steps, batch 8 × seq 256"


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else \
        jnp.dtype(dtype).name


def test_yi_100m_is_the_reference_config_and_prints_its_header(capsys, monkeypatch, tmp_path):
    ref = load("examples/train_lm.py", "jax_train_lm")
    seen = []

    class NoTraining:
        def __init__(self, cfg, mesh, **kw):
            seen.append((cfg, kw))

        def run(self, steps, log_every):
            return {"final_loss": 0.0, "losses": [0.0]}

    monkeypatch.setattr(ref, "TrainLoop", NoTraining)
    monkeypatch.setattr(ref, "make_host_mesh", lambda: None)
    monkeypatch.setattr("sys.argv", ["train_lm.py", "--ckpt-dir", str(tmp_path)])
    ref.main()
    want_header = capsys.readouterr().out.splitlines()[0]
    (jcfg, kw), = seen
    assert kw == {"batch": 8, "seq_len": 256, "ckpt_dir": str(tmp_path), "ckpt_every": 100}

    twin = load("examples/torch_train_lm.py", "torch_train_lm")
    cfg = twin.yi_100m()
    names = [f.name for f in dataclasses.fields(cfg)]
    assert names == [f.name for f in dataclasses.fields(jcfg)]
    for name in names:
        got, want = getattr(cfg, name), getattr(jcfg, name)
        if name == "dtype":
            got, want = _dtype_name(got), _dtype_name(want)
        assert got == want, name
    assert cfg.param_count() == jcfg.param_count()
    assert twin.header(cfg, 300, 8, 256) == want_header == HEADER


def test_train_lm_resumes_the_reference_run(capsys, tmp_path):
    jcfg = jax_smoke_config("yi_6b").replace(dtype=jnp.float32)
    tcfg = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    kw = dict(batch=2, seq_len=16)
    whole = JaxTrainLoop(jcfg, jax_host_mesh(), ckpt_dir=str(tmp_path / "ref"), ckpt_every=2,
                         **kw).run(4, log_every=0)
    assert ckpt.latest_step(tmp_path / "ref") == 4
    shutil.copytree(tmp_path / "ref" / "step_00000002", tmp_path / "twin" / "step_00000002")
    assert ckpt.latest_step(tmp_path / "twin") == 2

    twin = load("examples/torch_train_lm.py", "torch_train_lm_resume")
    out = twin.run(tcfg, steps=4, ckpt_dir=str(tmp_path / "twin"), device="cpu", ckpt_every=2,
                   log_every=0, **kw)
    assert out["restarts"] == 1 and len(out["losses"]) == 2
    np.testing.assert_allclose(out["losses"], whole["losses"][2:], rtol=1e-5)
    assert ckpt.latest_step(tmp_path / "twin") == 4
    lines = capsys.readouterr().out.splitlines()
    assert lines == [out["header"], *out["final"].splitlines()]
    assert out["header"] == "training yi-smoke: 0M params, 4 steps, batch 2 × seq 16"
    assert out["final"] == (f"\nfinal loss {out['losses'][-1]:.4f} (first "
                            f"{out['losses'][0]:.4f}); checkpoints in {tmp_path / 'twin'}")


def test_train_lm_main_on_the_cpu(capsys, monkeypatch, tmp_path):
    twin = load("examples/torch_train_lm.py", "torch_train_lm_main")
    monkeypatch.setattr(twin, "yi_100m", lambda: get_smoke_config("yi_6b"))
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]
    assert twin.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "training yi-smoke: 0M params, 2 steps, batch 2 × seq 16"
    assert lines[1].startswith("step     0 loss ")
    assert lines[-1].startswith("final loss ") and lines[-1].endswith(f"checkpoints in {tmp_path}")
