"""The port's checkpoints and fault-tolerant train loop
(``repro_torch.launch.checkpoint``, ``repro_torch.launch.train``) held
against the reference's (``repro.launch.checkpoint``,
``repro.launch.train``): the cases of ``tests/test_fault_tolerance.py``'s
``TestCheckpoint`` and ``TestTrainLoopFT`` on the port, checkpoints read
across the two frameworks bit for bit, the port continuing a run the
reference began, the NaN guard and the straggler re-issue driven with
forced losses and deadlines on both, and the train-then-serve case of
``tests/test_system.py``.

Both loops start from one state where losses are compared: the
reference's seeded float32 parameters and fresh AdamW state, written by
``repro.launch.checkpoint.save`` as step 0, which each loop resumes
from.  Losses then agree within 1e-5 relative (float32, ≈ 1e-7
measured: the same arithmetic in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import checkpoint as jck
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.train import TrainLoop as JaxTrainLoop
from repro.models import model_module as jax_model_module
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree, tensor_from_numpy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import checkpoint as ckpt
from repro_torch.launch import make_host_mesh
from repro_torch.launch.train import TrainLoop
from repro_torch.models import model_module
from repro_torch.train import abstract_opt_state, adamw_update
from repro_torch.train.train_step import batch_to_device

CPU = torch.device("cpu")
LOOP = dict(batch=2, seq_len=16)


def _mesh():
    return make_host_mesh(device="cpu")


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (a bfloat16 one as uint16), from either side."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones((5,), dtype=torch.bfloat16)}}
        ckpt.save(tmp_path, 7, tree, extra={"step": 7})
        assert ckpt.latest_step(tmp_path) == 7
        like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}}
        got, extra = ckpt.restore(tmp_path, 7, like, device="cpu")
        assert extra["step"] == 7
        assert torch.equal(got["a"], tree["a"])
        assert got["b"]["c"].dtype == torch.bfloat16 and torch.equal(got["b"]["c"], tree["b"]["c"])

    def test_uncommitted_ignored(self, tmp_path):
        p = ckpt.save(tmp_path, 1, {"a": torch.ones(3)})
        (p / "COMMIT").unlink()  # simulate crash mid-write
        assert ckpt.latest_step(tmp_path) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore(tmp_path, 1, {"a": torch.ones(3)}, device="cpu")

    def test_async_checkpointer(self, tmp_path):
        cp = ckpt.AsyncCheckpointer(tmp_path, keep=2)
        x = torch.zeros(4)
        for step in (1, 2, 3):
            x.fill_(float(step))  # in place, as the train step updates
            cp.save(step, {"x": x})
        x.fill_(-1.0)  # after save returned: the snapshot is already on the host
        cp.wait()
        assert ckpt.committed_steps(tmp_path) == [2, 3]  # GC kept the last 2
        got, _ = ckpt.restore(tmp_path, 3, {"x": torch.zeros(4)}, device="cpu")
        assert torch.equal(got["x"], torch.full((4,), 3.0))

    def test_structure_mismatch_rejected(self, tmp_path):
        ckpt.save(tmp_path, 1, {"a": torch.ones(3)})
        with pytest.raises(ValueError):
            ckpt.restore(tmp_path, 1, {"a": torch.ones(3), "b": torch.ones(2)}, device="cpu")

    def test_leaf_order_and_manifest_are_the_reference_s(self, tmp_path):
        """dict keys sorted, tuples in order, None holding no leaf: the
        port's file restores in the reference leaf for leaf, and the
        reference's in the port."""
        r = np.random.default_rng(0)
        tree = {"z": (r.normal(size=3).astype(np.float32), None, np.arange(4, dtype=np.int32)),
                "a": {"y": r.normal(size=(2, 2)).astype(np.float32), "b": np.int32(5)}}
        ckpt.save(tmp_path / "port", 3, tree, extra={"step": 3, "note": "x"})
        got, extra = jck.restore(tmp_path / "port", 3, tree)
        assert extra == {"step": 3, "note": "x"}
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert np.array_equal(np.asarray(g), w) and np.asarray(g).dtype == np.asarray(w).dtype
        jck.save(tmp_path / "ref", 3, tree, extra={"step": 3})
        back, _ = ckpt.restore(tmp_path / "ref", 3, tree, device="cpu")
        assert back["z"][1] is None
        for g, w in zip(ckpt._flatten(back)[0], jax.tree.leaves(tree)):
            assert np.array_equal(g.numpy(), np.asarray(w))


class TestTrainLoopFT:
    @pytest.fixture()
    def tiny_cfg(self):
        return get_smoke_config("yi_6b")

    def test_resume_from_checkpoint(self, tiny_cfg, tmp_path):
        loop = TrainLoop(tiny_cfg, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=5, **LOOP)
        out1 = loop.run(steps=10, log_every=0)
        assert ckpt.latest_step(tmp_path) == 10
        # "crash" and restart: a fresh loop resumes from step 10
        loop2 = TrainLoop(tiny_cfg, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=5, **LOOP)
        out2 = loop2.run(steps=12, log_every=0)
        assert loop2.restarts == 1
        assert len(out2["losses"]) == 2  # only steps 10, 11 re-run
        assert np.isfinite(out2["final_loss"]) and np.isfinite(out1["final_loss"])
        assert len(out2["grad_norms"]) == len(out2["step_ms"]) == 2

    def test_loss_decreases(self, tmp_path):
        """The reference's case from the reference's own start (its
        seeded float32 parameters, as step 0): 12 steps of the default
        schedule's warm-up move the loss by less than the batches' spread,
        so the port's own draws would test the data, not the trainer.
        ``scripts/train_loss_seeds.py`` shows it over seeds 0–7: the
        last loss is below the first for 3 of 8 on the reference (mean
        change −0.020, spread 0.387) and 5 of 8 on the port from its own
        draws (−0.013, 0.224); seed 0 passes on the reference and not on
        the port.  The port's draws are held to the reference's law by
        ``test_torch_train.py``'s ``test_init_params_draw_each_leaf_like_
        the_reference``."""
        jc, tc = _f32()
        _reference_start(jc, tmp_path)
        out = TrainLoop(tc, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=100,
                        **LOOP).run(steps=12, log_every=0)
        assert out["final_loss"] < out["losses"][0]

    def test_state_tree_copies_once_and_has_a_meta_form(self, tiny_cfg):
        """What the loop saves is one host copy of the state, sharing no
        memory with it; what it restores into is the abstract state's
        tree, the same structure, shapes and dtypes on meta."""
        loop = TrainLoop(tiny_cfg, _mesh(), **LOOP)
        params, opt, _ = loop.init_state()
        real, structure = ckpt._flatten(loop.state_tree(params, opt))
        aparams = model_module(tiny_cfg).abstract_params(tiny_cfg)
        meta, meta_structure = ckpt._flatten(loop.state_tree(aparams, abstract_opt_state(aparams)))
        assert meta_structure == structure and len(meta) == len(real)
        for r, m in zip(real, meta):
            assert m.is_meta and r.device == CPU and (m.shape, m.dtype) == (r.shape, r.dtype)
        state = list(params.parameters()) + [t for part in ("mu", "nu")
                                             for t in opt[part].values()] + [opt["step"]]
        assert not {t.data_ptr() for t in state} & {r.data_ptr() for r in real}

    def test_deterministic_batches(self):
        src = SyntheticTokens(100, 4, 8, seed=3)
        np.testing.assert_array_equal(src.batch_at(17)["tokens"], src.batch_at(17)["tokens"])

    def test_restore_places_the_leaves_on_the_device_asked(self, tiny_cfg, tmp_path):
        """The port's elastic restore: any device, the stored dtypes."""
        params = model_module(tiny_cfg).init_params(tiny_cfg, 0, device="cpu")
        ckpt.save(tmp_path, 1, lm_params_to_tree(tiny_cfg, params))
        got, _ = ckpt.restore(tmp_path, 1, lm_params_to_tree(tiny_cfg, params), device="cpu")
        back = dict(lm_params_from_numpy(tiny_cfg, got, device="cpu").named_parameters())
        assert set(back) == {n for n, _ in params.named_parameters()}
        for n, b in params.named_parameters():
            assert back[n].device == CPU and back[n].dtype == b.dtype
            assert torch.equal(back[n], b), n


# ---------------------------------------------------------------------------
# across the two frameworks
# ---------------------------------------------------------------------------


def _f32(arch="yi_6b"):
    return (jax_smoke_config(arch).replace(dtype=jnp.float32),
            get_smoke_config(arch).replace(dtype=torch.float32))


def _reference_start(jc, *dirs):
    """The reference's seeded parameters and fresh AdamW state, written as
    step 0 in each of ``dirs``."""
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    for d in dirs:
        jck.save(d, 0, {"params": jp, "opt": jopt.init_opt_state(jp)}, extra={"step": 0})


def _both_leaves_equal(port_tree, ref_tree):
    got, want = ckpt._flatten(port_tree)[0], jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _dtype(g) == str(np.asarray(w).dtype)
        assert np.array_equal(_bits(g), _bits(w))


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jc, tc = jax_smoke_config("yi_6b"), get_smoke_config("yi_6b")  # bfloat16
    jout = JaxTrainLoop(jc, jax_host_mesh(), ckpt_dir=str(tmp_path), ckpt_every=4,
                        **LOOP).run(4, log_every=0)
    loop = TrainLoop(tc, _mesh(), ckpt_dir=str(tmp_path), **LOOP)
    params, opt, start = loop.try_resume(*loop.init_state()[:2])
    assert start == 4 and loop.restarts == 1
    _both_leaves_equal(loop.state_tree(params, opt), {"opt": jout["opt"], "params": jout["params"]})
    assert params.embed.dtype == torch.bfloat16 and opt["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    jc, tc = jax_smoke_config("yi_6b"), get_smoke_config("yi_6b")  # bfloat16
    out = TrainLoop(tc, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=4, **LOOP).run(4, log_every=0)
    jloop = JaxTrainLoop(jc, jax_host_mesh(), ckpt_dir=str(tmp_path), **LOOP)
    params, opt, start = jloop.try_resume(*jloop.init_state()[:2])
    assert start == 4 and jloop.restarts == 1
    want = TrainLoop(tc, _mesh(), **LOOP).state_tree(out["params"], out["opt"])
    _both_leaves_equal(want, {"opt": opt, "params": params})
    assert params["embed"].dtype == jnp.bfloat16


def test_port_continues_the_reference_run(tmp_path):
    """The reference trains 12 steps in float32, checkpointing at 5 and
    10; the port resumes its step-10 checkpoint: its losses at steps 10
    and 11 are the reference's."""
    jc, tc = _f32()
    whole = JaxTrainLoop(jc, jax_host_mesh(), ckpt_dir=str(tmp_path), ckpt_every=5,
                         **LOOP).run(12, log_every=0)
    assert ckpt.latest_step(tmp_path) == 10
    loop = TrainLoop(tc, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=5, **LOOP)
    out = loop.run(12, log_every=0)
    assert loop.restarts == 1 and len(out["losses"]) == 2
    np.testing.assert_allclose(out["losses"], whole["losses"][10:], rtol=1e-5)


def _forced_runs(tmp_path, steps, force_port, force_ref, ckpt_every=2):
    """Both loops from the reference's step-0 state, each with its step
    forced by ``force_*(loop)``."""
    jc, tc = _f32()
    _reference_start(jc, tmp_path / "ref", tmp_path / "port")
    jloop = JaxTrainLoop(jc, jax_host_mesh(), ckpt_dir=str(tmp_path / "ref"),
                         ckpt_every=ckpt_every, **LOOP)
    force_ref(jloop)
    loop = TrainLoop(tc, _mesh(), ckpt_dir=str(tmp_path / "port"), ckpt_every=ckpt_every, **LOOP)
    force_port(loop)
    return loop, loop.run(steps, log_every=0), jloop, jloop.run(steps, log_every=0)


def _nan_at(call: int, fn, make_nan):
    calls = [0]

    def forced(*args):
        calls[0] += 1
        out = fn(*args)
        return make_nan(out) if calls[0] == call else out

    return forced


def test_nan_guard_reloads_the_last_checkpoint_and_skips_the_batch(tmp_path):
    """Step 3's loss forced to NaN: nothing of it is applied, the state
    at step 2 is reloaded, step 4 runs on it; as the reference does."""
    def port(loop):
        loop.grads = _nan_at(4, loop.grads, lambda o: (torch.tensor(float("nan")), o[1]))

    def ref(jloop):
        jloop.step_fn = _nan_at(4, jloop.step_fn,
                                lambda o: (o[0], o[1], {**o[2], "loss": jnp.float32(np.nan)}))
        save = jloop.checkpointer.save  # committed before the guard reads, as the port's

        def save_and_wait(*args, **kwargs):
            save(*args, **kwargs)
            jloop.checkpointer.wait()

        jloop.checkpointer.save = save_and_wait

    loop, out, jloop, jout = _forced_runs(tmp_path, 6, port, ref)
    assert loop.restarts == jloop.restarts == 2  # the start, then the reload
    assert len(out["losses"]) == len(jout["losses"]) == 5
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-5)


def test_nan_without_a_checkpoint_leaves_the_state_untouched():
    """No checkpoint to reload: the NaN step changes nothing, so the run
    equals one that never saw that batch's update."""
    tc = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    loop = TrainLoop(tc, _mesh(), **LOOP)
    loop.grads = _nan_at(2, loop.grads, lambda o: (torch.tensor(float("inf")), o[1]))
    out = loop.run(3, log_every=0)
    plain = TrainLoop(tc, _mesh(), **LOOP)
    params, opt, _ = plain.init_state()
    for step in (0, 2):
        _, grads = plain.grads(params, batch_to_device(plain.data.batch_at(step), CPU))
        adamw_update(plain.opt_cfg, params, grads, opt)
    assert len(out["losses"]) == 2 and int(out["opt"]["step"]) == 2
    for (n, a), (_, b) in zip(out["params"].named_parameters(), params.named_parameters()):
        assert torch.equal(a, b), n


def test_straggler_reissue_recomputes_the_same_step(tmp_path):
    """Every deadline forced to 0: each step is re-issued with the same
    batch from the same state, which changes no number; as the
    reference's re-issue."""
    def port(loop):
        loop._deadline = lambda: 0.0

    def ref(jloop):
        jloop._deadline = lambda: 0.0

    loop, out, jloop, jout = _forced_runs(tmp_path, 4, port, ref, ckpt_every=100)
    assert loop.stragglers == jloop.stragglers == 4
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-5)
    calm = TrainLoop(get_smoke_config("yi_6b").replace(dtype=torch.float32), _mesh(),
                     ckpt_dir=str(tmp_path / "port"), **LOOP)
    for (n, a), (_, b) in zip(out["params"].named_parameters(),
                              calm.run(4, log_every=0)["params"].named_parameters()):
        assert torch.equal(a, b), n


def test_train_then_serve(tmp_path):
    """Train a smoke model a few steps, checkpoint, reload, decode."""
    cfg = get_smoke_config("minitron_8b")
    loop = TrainLoop(cfg, _mesh(), ckpt_dir=str(tmp_path), ckpt_every=4, **LOOP)
    out = loop.run(steps=8, log_every=0)
    assert np.isfinite(out["final_loss"])
    step = ckpt.latest_step(tmp_path)
    assert step == 8
    mod = model_module(cfg)
    state, _ = ckpt.restore(tmp_path, step, loop.state_tree(out["params"], out["opt"]),
                            device="cpu")
    params = lm_params_from_numpy(cfg, state["params"], device="cpu")
    caches = mod.init_cache(cfg, 1, 8, device="cpu")
    with torch.inference_mode():
        mod.forward(params, torch.zeros((1, 4), dtype=torch.int32), cfg, caches=caches)
        logits, _ = mod.decode_step(params, caches, {"tokens": torch.zeros((1, 1), dtype=torch.int32),
                                                     "position": 4}, cfg)
    assert bool(torch.isfinite(logits).all())


def test_tensor_from_numpy_takes_restored_tensors():
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    got = tensor_from_numpy(t, CPU)
    assert torch.equal(got, t) and got.data_ptr() != t.data_ptr()
