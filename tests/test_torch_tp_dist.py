"""The ('data', 'model') mesh in gloo ranks held bit for bit to the
emulated form: one ``torch.multiprocessing`` spawn a world size — 2
ranks on a (1, 2) mesh, 4 on (2, 2), rank r at (r // 2, r % 2) — joined
with a hard limit (``test_torch_lm_shard.spawn_ranks``).  Each rank holds
only its blocks of the parameters, AdamW's moments and the caches.

* Two train steps with FSDP and SP on (yi, qwen3-moe at the configs'
  ``capacity_factor`` 1.25, recurrentgemma, xlstm — whose sLSTM input gate
  is held whole by one model shard a layer — and whisper without SP):
  the losses, gradient norms and every parameter block after the steps
  are the emulated form's bits.  The emulated run uses one thread, as
  each rank does: the embedding's gradient adds repeated rows in an
  order that depends on the thread count.
* Prefill and two decode steps (yi, recurrentgemma, whisper): the logits
  are the emulated form's bits, and every cache block has the local shape
  ``cache_pspecs`` gives it.
* A ``TrainLoop`` checkpoint written by the ranks at (1, 2) and (2, 2)
  resumes on a one-device mesh, and in the reference's loop, with the
  emulated loop's state bit for bit; ``checkpoint.restore`` with the
  state's specs hands each rank its blocks.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_to_tree
from repro_torch.launch import checkpoint as ckpt
from repro_torch.launch import make_host_mesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.sharding import cache_pspecs, local_block, local_shape
from repro_torch.launch.train import TrainLoop
from repro_torch.models import model_module
from repro_torch.serve.serve_step import step_form
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.optimizer import abstract_opt_state
from repro_torch.train.train_step import shard_params
from test_torch_lm_shard import rank_main, spawn_ranks
from test_torch_tp import run_serve, serve_batch, smoke, train_batch

TRAIN = ("yi_6b", "qwen3_moe_30b_a3b", "recurrentgemma_9b", "xlstm_125m", "whisper_base")
SERVE = ("yi_6b", "recurrentgemma_9b", "whisper_base")
WORLDS = {2: (1, 2), 4: (2, 2)}
LOOP = dict(batch=4, seq_len=32, ckpt_every=2, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))


def _blocks(out: dict, tag: str, named: dict, layouts, mesh) -> None:
    """Each block a shard holds, keyed by its coordinates."""
    for n, t in named.items():
        t = t.detach()
        if mesh.emulated:
            for d in range(mesh.data.size):
                for m in range(mesh.model.size):
                    out[f"{tag}{d}{m}:{n}"] = local_block(t, layouts[n], mesh, (d, m)).numpy()
        else:
            d, m = mesh.coords
            out[f"{tag}{d}{m}:{n}"] = t.numpy()


def run_mesh(D: int, M: int, ckpt_dir: str) -> dict:
    """The cases on a (D, M) mesh: the group when one is initialised,
    else emulated."""
    mesh, out = make_host_mesh(M, data=D, device="cpu"), {}
    for arch in TRAIN:
        cfg = smoke(arch, capacity_factor=1.25)
        params = model_module(cfg).init_params(cfg, 0, device="cpu")
        batch = train_batch(cfg)
        specs = {k: torch.empty(tuple(v.shape), device="meta") for k, v in batch.items()}
        fn, info = make_train_step(cfg, mesh, batch_specs=specs, fsdp=True,
                                   opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
        if not mesh.emulated:
            shard_params(params, mesh, info["layouts"])
        opt = init_opt_state(params)
        ms = [fn(params, opt, batch)[2] for _ in range(2)]
        out[f"train:{arch}:losses"] = np.array([float(m["loss"]) for m in ms])
        out[f"train:{arch}:norms"] = np.array([float(m["grad_norm"]) for m in ms])
        _blocks(out, f"train:{arch}:p", dict(params.named_parameters()), info["layouts"], mesh)
        _blocks(out, f"train:{arch}:mu", opt["mu"], info["layouts"], mesh)
    for arch in SERVE:
        cfg = smoke(arch)
        params = model_module(cfg).init_params(cfg, 0, device="cpu")
        form = step_form(cfg, mesh, batch=4, max_seq=32)
        if not mesh.emulated:
            shard_params(params, mesh, form["layouts"])
        got = run_serve(cfg, params, mesh, serve_batch(cfg))
        out[f"{arch}:logits"] = got["logits"]
        if not mesh.emulated:  # every cache block has cache_pspecs' local shape
            c_specs = model_module(cfg).cache_specs(cfg, 4, 32)
            specs = cache_pspecs(c_specs, mesh, batch=4, max_seq=32)
            layers = got["caches"]
            if isinstance(layers, dict):
                layers = [{**a, **b} for a, b in zip(layers["self"], layers["cross"])]
                c_specs = [{**a, **b} for a, b in zip(c_specs["self"], c_specs["cross"])]
                specs = [{**a, **b} for a, b in zip(specs["self"], specs["cross"])]
            out[f"{arch}:cache_ok"] = np.array(all(
                tuple(c[n].shape) == local_shape(tuple(w[n].shape), s[n], mesh)
                for c, w, s in zip(layers, c_specs, specs) for n in c))
    cfg = smoke("yi_6b")  # a checkpoint written on the mesh
    run = TrainLoop(cfg, mesh, ckpt_dir=ckpt_dir if not mesh.emulated else None,
                    **LOOP).run(2, log_every=0)
    out["loop:losses"] = np.array(run["losses"])
    loop = TrainLoop(cfg, mesh, **LOOP)
    tree = loop.state_tree(run["params"], run["opt"])
    out.update({f"loop:{i}": np.asarray(x.float()) for i, x in
                enumerate(ckpt._flatten(tree["params"])[0])})
    if not mesh.emulated:
        aparams = model_module(cfg).abstract_params(cfg)
        like = loop.state_tree(aparams, abstract_opt_state(aparams))
        pspecs = tsh.param_pspecs(lm_params_to_tree(cfg, aparams), mesh)
        shardings = {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}
        got, _ = ckpt.restore(ckpt_dir, 2, like, device="cpu", shardings=shardings,
                              mesh=mesh)
        d, m = mesh.coords
        out[f"restored{d}{m}:embed"] = got["params"]["embed"].float().numpy()
    return out


def _rank(rank, world, store, out_dir, ckpt_dir):
    D, M = WORLDS[world]
    rank_main(run_mesh, rank, world, store, out_dir, D, M, ckpt_dir)


@pytest.fixture(scope="module", params=list(WORLDS), ids=lambda w: f"world{w}")
def forms(request, tmp_path_factory):
    """(world, [per-rank answers], the emulated answers, checkpoint dir)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_tp{world}")
    ranks = spawn_ranks(_rank, world, tmp, str(tmp / "ckpt"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: the bits depend on the thread count
    try:
        emu = run_mesh(*WORLDS[world], str(tmp / "unused"))
    finally:
        torch.set_num_threads(threads)
    return world, ranks, emu, tmp / "ckpt"


@pytest.mark.parametrize("arch", TRAIN)
def test_group_train_steps_are_the_emulated_bits(forms, arch):
    world, ranks, emu, _ = forms
    assert np.isfinite(emu[f"train:{arch}:losses"]).all()
    for r, out in enumerate(ranks):
        keys = [k for k in out if k.startswith(f"train:{arch}:")]
        assert len(keys) > 2
        for k in keys:
            np.testing.assert_array_equal(out[k], emu[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("arch", SERVE)
def test_group_serving_is_the_emulated_bits_on_cache_blocks(forms, arch):
    world, ranks, emu, _ = forms
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{arch}:logits"], emu[f"{arch}:logits"])
        assert bool(out[f"{arch}:cache_ok"]), (r, arch)


def test_a_group_checkpoint_resumes_on_one_device_and_in_the_reference(forms):
    world, ranks, emu, ckpt_dir = forms
    for out in ranks:
        np.testing.assert_array_equal(out["loop:losses"], emu["loop:losses"])
    want = [emu[f"loop:{i}"] for i in range(sum(k.startswith("loop:") and k[5:].isdigit()
                                                for k in emu))]
    # one device resumes the ranks' step-2 checkpoint
    cfg = smoke("yi_6b")
    loop = TrainLoop(cfg, make_host_mesh(device="cpu"), ckpt_dir=str(ckpt_dir), **LOOP)
    params, opt, start = loop.try_resume(None, None)
    assert start == 2 and loop.restarts == 1
    got = ckpt._flatten(loop.state_tree(params, opt)["params"])[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.float()), w)
    # and so does the reference's loop
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.launch.train import TrainLoop as JaxTrainLoop

    jc = jax_smoke_config("yi_6b").replace(dtype=jnp.float32)
    jloop = JaxTrainLoop(jc, jax_host_mesh(), ckpt_dir=str(ckpt_dir), batch=4, seq_len=32)
    jparams, _, jstart = jloop.try_resume(*jloop.init_state()[:2])
    assert jstart == 2
    for g, w in zip(jax.tree.leaves(jparams), want):
        np.testing.assert_array_equal(np.asarray(g, dtype=np.float32), w)
    # the ranks restored their blocks of it by the parameter specs
    for r, out in enumerate(ranks):
        d, m = divmod(r, WORLDS[world][1])
        blk = out[f"restored{d}{m}:embed"]
        rows = want[0].shape[0] // 2  # embed ('model', None)
        np.testing.assert_array_equal(blk, want[0][m * rows:(m + 1) * rows])
