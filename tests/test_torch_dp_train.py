"""Data-parallel training and the int8 gradient reduction, held to
``repro.train.grad_compression`` and ``repro.train.train_step`` over a data
axis, and to the port's own one-device step.

* The reductions against JAX run in this process: ``jax.vmap(...,
  axis_name="data")`` over a leading P axis gives the reference's
  ``psum`` / ``pmax`` / ``pmean`` with no devices.  Codes, scales,
  rescaled codes, new residuals and the mean of every compressed leaf
  are held bit for bit; the float32 mean of a leaf under 1,024 elements
  to 1e-6 relative (the two sum P values in other orders).
* The steps against JAX run in one subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``: the reference's
  ``test_tp_dp_train_step`` at model = 1 (``make_train_step`` on a (4, 1)
  mesh, the qwen3-moe smoke config, 3 steps) and its
  ``test_compressed_dp_matches_uncompressed_direction`` (the yi smoke
  config, data = 8, 5 steps), both in float32 on the reference's
  parameters: every loss within 1e-4 of JAX's, and falling.
* The data-parallel step against the one-device step on the whole batch,
  at P = 2 and 4, emulated and in gloo ranks: the loss within 1e-6
  relative, every gradient leaf within 1e-5 relative L2.  The compressed
  step's losses, parameters and each shard's residuals are the same bits
  in both forms.
* The MoE over a data axis routes the global batch (fault C2): the
  qwen3-moe smoke config at ``capacity_factor`` 1.25 (every config's) and
  1.0, where experts drop tokens, at P = 2 and 4, emulated and in gloo
  ranks — the plain and the compressed step's loss within 1e-6 relative
  of the one-device step's, every gradient within 1e-5 of its largest
  element — and against the reference's GSPMD step on an 8-device mesh
  in the subprocess (loss within 1e-5, gradient norm within 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model_module as jax_model_module
from repro.train import grad_compression as jgc
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import make_host_mesh
from repro_torch.models import model_module
from repro_torch.train import (
    AdamWConfig,
    init_opt_state,
    init_residuals,
    loss_and_grads,
    make_compressed_train_step,
    make_train_step,
)
from repro_torch.train import grad_compression as tgc
from repro_torch.train.train_step import dp_loss_and_grads
from test_torch_lm_shard import rank_main, run_jax, spawn_ranks

WORLDS = (2, 4)
SHARDS = (2, 4, 8)
TP_DP = ("qwen3_moe_30b_a3b", (8, 64), 4, 3)  # arch, batch, data shards, steps
COMPRESSED = ("yi_6b", (8, 32), 8, 5)
C2 = ("qwen3_moe_30b_a3b", (8, 64), (1.25, 1.0))  # arch, batch, capacity factors


# ---------------------------------------------------------------------------
# the reductions, bit for bit
# ---------------------------------------------------------------------------


def _leaves(P: int, seed: int = 0) -> tuple[dict, dict]:
    """Per-shard gradients and residuals (leading P axis): half-way values
    for the rounding, an all-zero leaf, leaves of 1,023 and 1,024
    elements and a matrix."""
    r = np.random.default_rng(seed + P)
    half = np.tile(np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, -126.5], np.float32), 128)
    half[0] = 127.0  # amax 127: the scale is exactly 1, each x/scale a half
    g = {"half": np.stack([half * (1 if p == 0 else 0.5 ** p) for p in range(P)]),
         "zero": np.zeros((P, 2048), np.float32),
         "small": r.normal(size=(P, 1023)).astype(np.float32),
         "edge": r.normal(size=(P, 1024)).astype(np.float32),
         "mat": (r.normal(size=(P, 64, 32)) * 1e-3).astype(np.float32)}
    res = {k: (np.zeros_like(v) if k in ("zero", "half")
               else (r.normal(size=v.shape) * 1e-3).astype(np.float32)) for k, v in g.items()}
    return g, res


def _per_shard(tree: dict, P: int) -> list[dict]:
    return [{k: torch.from_numpy(v[p].copy()) for k, v in tree.items()} for p in range(P)]


@pytest.mark.parametrize("name", ["half", "zero", "small", "edge", "mat"])
def test_quantize_and_feedback_match_jax_bit_for_bit(name):
    g, res = _leaves(1)
    x, r = g[name][0], res[name][0]
    jq, js = jgc.quantize(jnp.asarray(x))
    tq, ts = tgc.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.item() == float(js)
    jq, js, jr = jgc.compress_with_feedback(jnp.asarray(x), jnp.asarray(r))
    tq, ts, tr = tgc.compress_with_feedback(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tgc.dequantize(tq, ts).numpy(),
                                  np.asarray(jgc.dequantize(jq, js)))
    if name == "zero":
        assert ts.item() == np.float32(1e-12) / np.float32(127.0)
    if name == "half":  # round half to even: 0.5 → 0, 1.5 → 2, 2.5 → 2, 126.5 → 126
        assert ts.item() == 1.0 and tq[:9].tolist() == [127, 2, 2, 0, -2, 4, 126, -126, 0]


@pytest.mark.parametrize("P", SHARDS)
def test_tree_compress_psum_matches_jax_bit_for_bit(P):
    g, res = _leaves(P)
    jmean, jres = jax.vmap(lambda a, b: jgc.tree_compress_psum(a, b, "data"),
                           axis_name="data")(g, res)
    mesh = make_host_mesh(data=P, device="cpu").data
    tmean, tres = tgc.tree_compress_psum(_per_shard(g, P), _per_shard(res, P), mesh)
    for k in g:
        want = np.asarray(jmean[k])
        assert all(np.array_equal(want[0], w) for w in want)  # replicated
        if g[k][0].size < tgc.MIN_COMPRESSED:
            np.testing.assert_allclose(tmean[k].numpy(), want[0], rtol=1e-6)
        else:
            np.testing.assert_array_equal(tmean[k].numpy(), want[0], err_msg=k)
        for p in range(P):
            np.testing.assert_array_equal(tres[p][k].numpy(), np.asarray(jres[k][p]), err_msg=k)
    assert (tmean["zero"] == 0).all()


@pytest.mark.parametrize("P", SHARDS)
def test_rescaled_codes_and_compressed_psum_match_jax_bit_for_bit(P):
    g, res = _leaves(P)

    def reference(x, r):  # the reference's rescale, line for line, and its psum
        q, scale, _ = jgc.compress_with_feedback(x, r)
        smax = jax.lax.pmax(scale, "data")
        qc = jnp.clip(jnp.round(q.astype(jnp.float32) * (scale / smax)), -127, 127
                      ).astype(jnp.int8)
        return q, scale, qc, jgc.compressed_psum(q, scale, "data")

    mesh = make_host_mesh(data=P, device="cpu").data
    for k in ("half", "edge", "mat"):
        jq, js, jqc, jsum = jax.vmap(reference, axis_name="data")(g[k], res[k])
        coded = [tgc.compress_with_feedback(torch.from_numpy(g[k][p]), torch.from_numpy(res[k][p]))
                 for p in range(P)]
        smax = mesh.pmax([s for _, s, _ in coded])
        for p, (q, s, _) in enumerate(coded):
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq[p]))
            assert s.item() == float(js[p])
            np.testing.assert_array_equal(tgc.rescale_codes(q, s, smax).numpy(),
                                          np.asarray(jqc[p]), err_msg=k)
        got = tgc.compressed_psum([q for q, _, _ in coded], [s for _, s, _ in coded], mesh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsum[0]), err_msg=k)


# ---------------------------------------------------------------------------
# the steps against the reference's (one 8-device subprocess)
# ---------------------------------------------------------------------------

_JAX = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_submesh
from repro.configs import get_smoke_config
from repro.models import model_module
from repro.train.grad_compression import init_residuals, make_compressed_train_step
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.train_step import make_train_step
out = {}
arch, (B, S), P, steps = TP_DP
cfg = get_smoke_config(arch).replace(dtype=jnp.float32)
mesh = make_submesh((P, 1), ("data", "model"))
specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
step, _ = make_train_step(cfg, mesh, batch_specs=specs, donate=False,
                          opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
opt = init_opt_state(params)
toks = jnp.asarray(np.load(IN)["tp_dp"])
losses = []
for _ in range(steps):
    params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
    losses.append(float(m["loss"]))
out["tp_dp_losses"] = np.array(losses)

arch, (B, S), P, steps = COMPRESSED
cfg = get_smoke_config(arch).replace(dtype=jnp.float32)
mesh = make_submesh((P,), ("data",))
params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
opt, res = init_opt_state(params), init_residuals(params)
step = make_compressed_train_step(cfg, mesh, AdamWConfig(lr=1e-3))
toks = jnp.asarray(np.load(IN)["compressed"])
losses = []
with mesh:
    for _ in range(steps):
        params, opt, res, m = step(params, opt, res, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
out["compressed_losses"] = np.array(losses)

arch, (B, S), caps = C2
mesh = make_submesh((8, 1), ("data", "model"))
specs = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
toks = jnp.asarray(np.load(IN)["c2"])
for cap in caps:
    cfg = get_smoke_config(arch).replace(dtype=jnp.float32, capacity_factor=cap)
    step, _ = make_train_step(cfg, mesh, batch_specs=specs, donate=False)
    params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
    _, _, m = step(params, init_opt_state(params), {"tokens": toks, "labels": toks})
    out[f"c2_{cap}"] = np.array([float(m["loss"]), float(m["grad_norm"])])
np.savez(OUT, **out)
"""


def _tokens(arch: str, shape) -> np.ndarray:
    """The reference's test batch: ``default_rng(0)`` over the vocabulary."""
    return np.random.default_rng(0).integers(0, jax_smoke_config(arch).vocab_size,
                                             shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    inputs = {"tp_dp": _tokens(TP_DP[0], TP_DP[1]),
              "compressed": _tokens(COMPRESSED[0], COMPRESSED[1]),
              "c2": _tokens(C2[0], C2[1])}
    return run_jax(_JAX, inputs, tmp_path_factory.mktemp("jax_dp"), TP_DP=TP_DP,
                   COMPRESSED=COMPRESSED, C2=C2)


def _reference_params(arch: str):
    jc = jax_smoke_config(arch).replace(dtype=jnp.float32)
    tc = get_smoke_config(arch).replace(dtype=torch.float32)
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    return tc, lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")


def test_data_parallel_step_matches_the_reference_tp_dp_case(jax_steps):
    arch, (B, S), P, steps = TP_DP
    tc, params = _reference_params(arch)
    specs = {k: torch.empty((B, S), device="meta") for k in ("tokens", "labels")}
    fn, info = make_train_step(tc, make_host_mesh(data=P, device="cpu"), batch_specs=specs,
                               opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
    assert info["data_parallel"] and info["batch_pspecs"]["tokens"] == ("data", None)
    opt, toks = init_opt_state(params), _tokens(arch, (B, S))
    losses = [float(fn(params, opt, {"tokens": toks, "labels": toks})[2]["loss"])
              for _ in range(steps)]
    want = jax_steps["tp_dp_losses"]
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0] and want[-1] < want[0]


def test_compressed_step_matches_the_reference_case(jax_steps):
    arch, (B, S), P, steps = COMPRESSED
    tc, params = _reference_params(arch)
    mesh = make_host_mesh(data=P, device="cpu")
    fn = make_compressed_train_step(tc, mesh, AdamWConfig(lr=1e-3))
    opt, res, toks = init_opt_state(params), init_residuals(params, mesh), _tokens(arch, (B, S))
    losses = []
    for _ in range(steps):
        params, opt, res, m = fn(params, opt, res, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
    want = jax_steps["compressed_losses"]
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0] and want[-1] < want[0]


# ---------------------------------------------------------------------------
# against the one-device step, emulated and in gloo ranks
# ---------------------------------------------------------------------------

ONE = ("yi_6b", (8, 32))


def _one_setup():
    arch, (B, S) = ONE
    tc = get_smoke_config(arch).replace(dtype=torch.float32)
    toks = _tokens(arch, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    return tc, batch


def run_dp(mesh) -> dict:
    """The data-parallel loss and gradients, two plain DP steps and three
    compressed ones from the port's own seeded state, on ``mesh``."""
    tc, batch = _one_setup()
    mod, out = model_module(tc), {}
    params = mod.init_params(tc, 0, device="cpu")
    loss, grads = dp_loss_and_grads(params, batch, mesh, cfg=tc)
    out["loss"] = loss.numpy()
    out.update({f"grad:{n}": g.numpy() for n, g in grads.items() if g is not None})
    specs = {k: torch.empty(tuple(v.shape), device="meta") for k, v in batch.items()}
    fn, _ = make_train_step(tc, mesh, batch_specs=specs, opt_cfg=AdamWConfig(lr=3e-3))
    opt = init_opt_state(params)
    out["dp_losses"] = np.array([float(fn(params, opt, batch)[2]["loss"]) for _ in range(2)])
    params = mod.init_params(tc, 0, device="cpu")
    cfn = make_compressed_train_step(tc, mesh, AdamWConfig(lr=3e-3))
    opt, res = init_opt_state(params), init_residuals(params, mesh)
    losses = []
    for _ in range(3):
        params, opt, res, m = cfn(params, opt, res, batch)
        losses.append(m["loss"].numpy())
    out["c_losses"] = np.array(losses)
    out.update({f"c_param:{n}": p.detach().numpy() for n, p in params.named_parameters()})
    for p, r in zip(mesh.data.local, res):
        out.update({f"c_res{p}:{n}": t.numpy() for n, t in r.items()})
    out.update(run_c2(mesh))
    return out


def _c2_setup(cap: float):
    arch, (B, S), _ = C2
    tc = get_smoke_config(arch).replace(dtype=torch.float32, capacity_factor=cap)
    toks = torch.from_numpy(_tokens(arch, (B, S)))
    return tc, {"tokens": toks, "labels": toks}


def run_c2(mesh) -> dict:
    """At each dropping capacity: the data-parallel loss and mean
    gradients, and the compressed step's first loss, on ``mesh``."""
    out = {}
    for cap in C2[2]:
        tc, batch = _c2_setup(cap)
        params = model_module(tc).init_params(tc, 0, device="cpu")
        loss, grads = dp_loss_and_grads(params, batch, mesh, cfg=tc)
        out[f"c2_{cap}:loss"] = loss.numpy()
        out.update({f"c2_{cap}:grad:{n}": g.numpy() for n, g in grads.items() if g is not None})
        fn = make_compressed_train_step(tc, mesh)
        _, _, _, m = fn(params, init_opt_state(params), init_residuals(params, mesh), batch)
        out[f"c2_{cap}:c_loss"] = m["loss"].numpy()
    return out


def _group_body():
    return run_dp(make_host_mesh(device="cpu"))


def _rank(rank, world, store, out_dir):
    rank_main(_group_body, rank, world, store, out_dir)


@pytest.fixture(scope="module")
def one_device():
    tc, batch = _one_setup()
    params = model_module(tc).init_params(tc, 0, device="cpu")
    loss, grads = loss_and_grads(params, batch, cfg=tc)
    return float(loss), {n: g for n, g in grads.items() if g is not None}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def dp_forms(request, tmp_path_factory):
    """(world, {"emulated": answers, "rank<r>": answers})."""
    world = request.param
    ranks = spawn_ranks(_rank, world, tmp_path_factory.mktemp(f"gloo_dp{world}"))
    forms = {f"rank{r}": out for r, out in enumerate(ranks)}
    forms["emulated"] = run_dp(make_host_mesh(data=world, device="cpu"))
    return world, forms


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_dp_gradients_match_the_one_device_step(dp_forms, one_device):
    _, forms = dp_forms
    want_loss, want = one_device
    for form, out in forms.items():
        assert abs(float(out["loss"]) - want_loss) <= 1e-6 * abs(want_loss), form
        assert sorted(k[5:] for k in out if k.startswith("grad:")) == sorted(want)
        for n, g in want.items():
            assert _rel_l2(out[f"grad:{n}"], g.numpy()) <= 1e-5, (form, n)


def test_dp_step_losses_match_the_one_device_step(dp_forms):
    tc, batch = _one_setup()
    params = model_module(tc).init_params(tc, 0, device="cpu")
    specs = {k: torch.empty(tuple(v.shape), device="meta") for k, v in batch.items()}
    fn, info = make_train_step(tc, make_host_mesh(device="cpu"), batch_specs=specs,
                               opt_cfg=AdamWConfig(lr=3e-3))
    assert not info["data_parallel"]
    opt = init_opt_state(params)
    want = [float(fn(params, opt, batch)[2]["loss"]) for _ in range(2)]
    for form, out in dp_forms[1].items():
        np.testing.assert_allclose(out["dp_losses"], want, rtol=1e-5, err_msg=form)


def test_compressed_step_is_the_same_bits_emulated_and_in_a_group(dp_forms):
    world, forms = dp_forms
    emu = forms["emulated"]
    assert np.isfinite(emu["c_losses"]).all() and emu["c_losses"][-1] < emu["c_losses"][0]
    for r in range(world):
        out = forms[f"rank{r}"]
        for k, v in out.items():
            if k.startswith(("c_losses", "c_param:", f"c_res{r}:")):
                np.testing.assert_array_equal(v, emu[k], err_msg=f"rank {r}: {k}")


def test_the_batch_that_does_not_divide_is_replicated_and_the_compressed_step_refuses_it():
    tc, batch = _one_setup()
    odd = {k: v[:3] for k, v in batch.items()}
    specs = {k: torch.empty(tuple(v.shape), device="meta") for k, v in odd.items()}
    mesh = make_host_mesh(data=2, device="cpu")
    fn, info = make_train_step(tc, mesh, batch_specs=specs)
    assert not info["data_parallel"] and info["batch_pspecs"]["tokens"] == (None, None)
    params = model_module(tc).init_params(tc, 0, device="cpu")
    cfn = make_compressed_train_step(tc, mesh)
    with pytest.raises(ValueError, match="does not split over 2 shards"):
        cfn(params, init_opt_state(params), init_residuals(params, mesh), odd)
    _, finfo = make_train_step(tc, mesh, batch_specs=specs, fsdp=True)  # runs (A12d3)
    assert finfo["parallel"] and not finfo["data_parallel"]


# ---------------------------------------------------------------------------
# fault C2: the MoE routes the global batch over the data axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def c2_one_device():
    out = {}
    for cap in C2[2]:
        tc, batch = _c2_setup(cap)
        params = model_module(tc).init_params(tc, 0, device="cpu")
        loss, grads = loss_and_grads(params, batch, cfg=tc)
        out[cap] = (float(loss), {n: g.numpy() for n, g in grads.items() if g is not None})
    return out


def _largest(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cap", C2[2])
def test_moe_dp_at_dropping_capacity_matches_the_one_device_step(dp_forms, c2_one_device, cap):
    want_loss, want = c2_one_device[cap]
    for form, out in dp_forms[1].items():
        for key in ("loss", "c_loss"):
            assert abs(float(out[f"c2_{cap}:{key}"]) - want_loss) <= 1e-6 * abs(want_loss), \
                (form, key)
        for n, g in want.items():
            assert _largest(out[f"c2_{cap}:grad:{n}"], g) <= 1e-5, (form, n)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("cap", C2[2])
def test_moe_dp_at_dropping_capacity_matches_the_reference_gspmd_step(jax_steps, cap, P):
    tc, batch = _c2_setup(cap)
    jc = jax_smoke_config(C2[0]).replace(dtype=jnp.float32, capacity_factor=cap)
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    specs = {k: torch.empty(tuple(v.shape), device="meta") for k, v in batch.items()}
    fn, info = make_train_step(tc, make_host_mesh(data=P, device="cpu"), batch_specs=specs)
    assert info["data_parallel"]
    m = fn(params, init_opt_state(params), batch)[2]
    want_loss, want_norm = jax_steps[f"c2_{cap}"]
    assert abs(float(m["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(float(m["grad_norm"]) - want_norm) <= 1e-4 * abs(want_norm)
