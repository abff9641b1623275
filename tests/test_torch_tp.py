"""The ('data', 'model') mesh on the emulated form: tensor, expert and
sequence parallelism and FSDP (``repro_torch.models.parallel``) held to
the port's one-device step, and the reference's two multi-device cases
held to JAX.

* Every family's smoke config in float32 — yi (dense), qwen3-moe,
  recurrentgemma (hybrid), xlstm (ssm), whisper (encdec) — at (1, 2),
  (2, 2) and (4, 2), with FSDP and SP off and on: the loss within 1e-6
  relative and every gradient leaf within 1e-5 of its largest element
  of the one-device step's; prefill and three decode steps' logits
  within 1e-5 of the largest, with the same greedy tokens.
* The reference's ``test_tp_dp_train_step`` (qwen3-moe on (4, 2), three
  steps) and ``test_serve_decode_sharded`` (recurrentgemma on (4, 2),
  B = 4, a 16-token prefill and one decode step) in one JAX subprocess
  under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, on the
  reference's parameters carried across: the losses within 1e-5 and
  falling, the logits within 1e-5 of the largest.
* The 2-D PM-LSH decode over ('data', 'model') at (4, 2) and (2, 4):
  positions and output bit for bit the data = 8 form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model_module as jax_model_module
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import make_host_mesh
from repro_torch.models import lsh_attention as tl
from repro_torch.models import model_module
from repro_torch.serve.serve_step import make_decode_step, make_prefill, step_form
from repro_torch.train import AdamWConfig, init_opt_state, loss_and_grads, make_train_step
from repro_torch.train.train_step import sp_rule, tp_loss_and_grads
from repro_torch.launch.sharding import layer_layouts
from test_torch_lm_shard import run_jax

FAMILIES = ("yi_6b", "qwen3_moe_30b_a3b", "recurrentgemma_9b", "xlstm_125m", "whisper_base")
MESHES = ((1, 2), (2, 2), (4, 2))
B, S = 4, 32
SERVE_B, PROMPT, MAX_SEQ, DECODE = 4, 16, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs this file beside five other
    workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def smoke(arch: str, **kw):
    return get_smoke_config(arch).replace(dtype=torch.float32, **kw)


def train_batch(cfg, b: int = B, s: int = S) -> dict:
    """Seeded next-token batch (and the modality stub) for ``cfg``."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    if cfg.family == "encdec":
        batch["audio_frames"] = torch.from_numpy(
            rng.normal(size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    return batch


def serve_batch(cfg, b: int = SERVE_B) -> dict:
    rng = np.random.default_rng(1)
    req = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, PROMPT)))}
    if cfg.family == "encdec":
        req["audio_frames"] = torch.from_numpy(
            rng.normal(size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    return req


def run_serve(cfg, params, mesh, req: dict, tokens=None) -> dict:
    """Prefill and ``DECODE`` greedy steps on ``mesh`` (the tokens fed are
    ``tokens`` where given): the logits of each step, the tokens, and the
    caches' shapes."""
    pre, _ = make_prefill(cfg, mesh, batch=req["tokens"].shape[0], seq_len=PROMPT,
                          max_seq=MAX_SEQ)
    dec, _ = make_decode_step(cfg, mesh, batch=req["tokens"].shape[0], max_seq=MAX_SEQ)
    logits, caches = pre(params, req)
    steps, toks = [logits], []
    for i in range(DECODE):
        t = (logits.argmax(-1) if tokens is None else torch.from_numpy(tokens[:, i:i + 1]))
        toks.append(t)
        logits, caches = dec(params, caches, {"tokens": t, "position": PROMPT + i})
        steps.append(logits)
    return {"logits": torch.cat(steps, 1).numpy(), "tokens": torch.cat(toks, 1).numpy(),
            "caches": caches}


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


_ONE = {}


def one_device(arch: str):
    """The port's one-device loss, gradients and serving answers."""
    if arch not in _ONE:
        cfg = smoke(arch)
        params = model_module(cfg).init_params(cfg, 0, device="cpu")
        loss, grads = loss_and_grads(params, train_batch(cfg), cfg=cfg)
        served = run_serve(cfg, params, make_host_mesh(device="cpu"), serve_batch(cfg))
        _ONE[arch] = (cfg, params, float(loss), {n: g for n, g in grads.items()
                                                 if g is not None}, served)
    return _ONE[arch]


# ---------------------------------------------------------------------------
# against the port's one-device step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp_sp", [False, True], ids=["plain", "fsdp_sp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_the_one_device_step(arch, shape, fsdp_sp):
    cfg, params, want_loss, want, _ = one_device(arch)
    D, M = shape
    mesh = make_host_mesh(M, data=D, device="cpu")
    layouts = layer_layouts(cfg, mesh, fsdp=fsdp_sp)
    sp = sp_rule(cfg, mesh, S) if fsdp_sp else None
    assert (sp is not None) == (fsdp_sp and cfg.family != "encdec")
    loss, grads = tp_loss_and_grads(params, train_batch(cfg), mesh, cfg=cfg, layouts=layouts,
                                    sp_spec=sp)
    assert abs(float(loss) - want_loss) <= 1e-6 * abs(want_loss)
    assert sorted(n for n, g in grads.items() if g is not None) == sorted(want)
    for n, g in want.items():
        assert rel_err(grads[n].numpy(), g.numpy()) <= 1e-5, n


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_one_device_steps(arch, shape):
    cfg, params, _, _, want = one_device(arch)
    D, M = shape
    mesh = make_host_mesh(M, data=D, device="cpu")
    form = step_form(cfg, mesh, batch=SERVE_B, max_seq=MAX_SEQ)
    assert form["parallel"] and form["split"] == (SERVE_B % D == 0 and D > 1)
    got = run_serve(cfg, params, mesh, serve_batch(cfg), tokens=want["tokens"])
    assert rel_err(got["logits"], want["logits"]) <= 1e-5
    np.testing.assert_array_equal(got["logits"].argmax(-1)[:, :DECODE], want["tokens"])


def test_make_train_step_runs_fsdp_and_sp_and_the_loss_falls():
    cfg = smoke("qwen3_moe_30b_a3b", capacity_factor=1.25)
    params = model_module(cfg).init_params(cfg, 0, device="cpu")
    specs = {k: torch.empty((B, S), device="meta") for k in ("tokens", "labels")}
    fn, info = make_train_step(cfg, make_host_mesh(2, data=2, device="cpu"),
                               batch_specs=specs, fsdp=True,
                               opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
    assert info["parallel"] and info["data_parallel"] and info["sp_spec"] == ("data", "model",
                                                                             None)
    assert info["opt_pspecs"]["mu"] == info["param_pspecs"] and info["opt_pspecs"]["step"] == ()
    opt, batch = init_opt_state(params), train_batch(cfg)
    losses = [float(fn(params, opt, batch)[2]["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the reference's two multi-device cases (one 8-device JAX subprocess)
# ---------------------------------------------------------------------------

_JAX = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_smoke_config
from repro.models import model_module
from repro.serve.serve_step import make_decode_step, make_prefill
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.train_step import make_train_step
out = {}
mesh = make_mesh((4, 2), ("data", "model"))
cfg = get_smoke_config("qwen3_moe_30b_a3b").replace(dtype=jnp.float32)
specs = {k: jax.ShapeDtypeStruct((8, 64), jnp.int32) for k in ("tokens", "labels")}
step, _ = make_train_step(cfg, mesh, batch_specs=specs, donate=False,
                          opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
opt = init_opt_state(params)
toks = jnp.asarray(np.load(IN)["tp_tokens"])
losses = []
for _ in range(3):
    params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
    losses.append(float(m["loss"]))
out["tp_losses"] = np.array(losses)

cfg = get_smoke_config("recurrentgemma_9b").replace(dtype=jnp.float32)
pf, _ = make_prefill(cfg, mesh, batch=4, seq_len=16, max_seq=32)
dec, _ = make_decode_step(cfg, mesh, batch=4, max_seq=32)
params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
x = np.load(IN)
logits, caches = pf(params, {"tokens": jnp.asarray(x["serve_prompt"])})
l2, caches = dec(params, caches, {"tokens": jnp.asarray(x["serve_next"]),
                                  "position": jnp.int32(16)})
out["serve_prefill"], out["serve_decode"] = np.asarray(logits), np.asarray(l2)
np.savez(OUT, **out)
"""


def _reference_params(arch: str):
    jc = jax_smoke_config(arch).replace(dtype=jnp.float32)
    tc = smoke(arch)
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    return tc, lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")


def _reference_inputs() -> dict:
    rng = np.random.default_rng(0)
    tp = rng.integers(0, jax_smoke_config("qwen3_moe_30b_a3b").vocab_size, (8, 64))
    rng = np.random.default_rng(0)
    V = jax_smoke_config("recurrentgemma_9b").vocab_size
    prompt = rng.integers(0, V, (4, 16))
    nxt = rng.integers(0, V, (4, 1))
    return {"tp_tokens": tp.astype(np.int32), "serve_prompt": prompt.astype(np.int32),
            "serve_next": nxt.astype(np.int32)}


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    return run_jax(_JAX, _reference_inputs(), tmp_path_factory.mktemp("jax_tp"))


def test_tp_dp_train_step_matches_the_reference(jax_cases):
    tc, params = _reference_params("qwen3_moe_30b_a3b")
    specs = {k: torch.empty((8, 64), device="meta") for k in ("tokens", "labels")}
    fn, info = make_train_step(tc, make_host_mesh(2, data=4, device="cpu"), batch_specs=specs,
                               opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1))
    assert info["parallel"] and info["data_parallel"]
    opt, toks = init_opt_state(params), _reference_inputs()["tp_tokens"]
    losses = [float(fn(params, opt, {"tokens": toks, "labels": toks})[2]["loss"])
              for _ in range(3)]
    want = jax_cases["tp_losses"]
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    assert losses[-1] < losses[0] and want[-1] < want[0]


def test_serve_decode_sharded_matches_the_reference(jax_cases):
    tc, params = _reference_params("recurrentgemma_9b")
    mesh = make_host_mesh(2, data=4, device="cpu")
    x = _reference_inputs()
    pre, _ = make_prefill(tc, mesh, batch=4, seq_len=16, max_seq=32)
    dec, _ = make_decode_step(tc, mesh, batch=4, max_seq=32)
    logits, caches = pre(params, {"tokens": torch.from_numpy(x["serve_prompt"])})
    l2, caches = dec(params, caches, {"tokens": torch.from_numpy(x["serve_next"]),
                                      "position": 16})
    assert rel_err(logits.numpy(), jax_cases["serve_prefill"]) <= 1e-5
    assert rel_err(l2.numpy(), jax_cases["serve_decode"]) <= 1e-5
    assert np.isfinite(l2.numpy()).all() and l2.shape[0] == 4


# ---------------------------------------------------------------------------
# the 2-D PM-LSH decode
# ---------------------------------------------------------------------------


def lsh_case(seed: int = 0, Smax: int = 512, KV: int = 2, G: int = 2, hd: int = 16,
             m: int = 16) -> dict:
    """A B = 1 decode's query and a float32 cache of ``Smax`` rows."""
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))  # noqa: E731
    k = f(1, Smax, KV, hd)
    a = f(hd, m)
    return {"q": f(1, 1, KV * G, hd), "k": k, "v": f(1, Smax, KV, hd),
            "pk": torch.einsum("bskd,dm->bskm", k, a), "a": a}


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kv_len,topk", [(400, 64), (512, 100), (37, 48)])
def test_2d_lsh_decode_is_the_data_8_form_bit_for_bit(shape, kv_len, topk):
    x = lsh_case()
    args = (x["q"], x["k"], x["v"], x["pk"], x["a"])
    want, wpos = tl.lsh_decode_attention_sharded(
        *args, kv_len=kv_len, topk=topk, mesh=make_host_mesh(data=8, device="cpu"),
        axis="data", return_positions=True)
    mesh = make_host_mesh(shape[1], data=shape[0], device="cpu")
    got, pos = tl.lsh_decode_attention_sharded(
        *args, kv_len=kv_len, topk=topk, mesh=mesh, axis=("data", "model"),
        return_positions=True)
    np.testing.assert_array_equal(pos.numpy(), wpos.numpy())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_long_context_decode_on_a_2d_mesh_takes_the_combined_axis():
    cfg = smoke("yi_6b")
    params = model_module(cfg).init_params(cfg, 0, device="cpu")
    req = {"tokens": serve_batch(cfg, 1)["tokens"]}
    want = run_serve(cfg, params, make_host_mesh(data=8, device="cpu"), req)
    for D, M in ((4, 2), (2, 4)):
        mesh = make_host_mesh(M, data=D, device="cpu")
        _, info = make_decode_step(cfg, mesh, batch=1, max_seq=MAX_SEQ)
        assert info["lsh_shard"] == ("data", "model")
        got = run_serve(cfg, params, mesh, req, tokens=want["tokens"])
        assert rel_err(got["logits"], want["logits"]) <= 1e-5
