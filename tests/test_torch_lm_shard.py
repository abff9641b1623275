"""The sequence-sharded PM-LSH decode (the tournament merge), its cache
layout and the rule that picks it, held to ``repro.models.lsh_attention``,
``repro.serve.serve_step`` and ``repro.launch.sharding``.

The JAX side runs as the reference's multi-device tests run it: one
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
builds (P, 1) meshes of its first P devices and hands every array back in
an ``.npz``.  The group form runs in gloo ranks of 2 and 4, spawned over a
file store and joined with a hard 120-s limit, each holding only its
blocks of the cache; it must equal the emulated form bit for bit.

Tolerances:

* ``lsh_decode_attention_sharded`` on float32 inputs within 1e-5
  relative of JAX's entry by entry (1e-7 absolute where a sum cancels
  near zero: 2.6e-8 measured on an entry of 1.2e-3), on bfloat16 within 1e-4 of the largest output (the
  two frameworks sum the float32 products in other orders); the gathered
  positions identical to a per-shard ``lax.top_k`` of the reference's
  scores; at P = 1 on float32 the unsharded form bit for bit;
* the model steps' logits within 1e-4 of the largest logit, as
  ``test_torch_lm_serve.py`` holds the unsharded steps, a chunk of S
  tokens past the prompt too (its attention the shards' partials merged
  in another order than one pass); its cache bit for bit one device's in
  layer 0, whose input is the embedding on every form;
* the specs equal, entry for entry.
"""
import os
import subprocess
import sys
import time
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import base as jcb
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import sharding as jsh
from repro.models import model_module as jax_model_module
from repro_torch.configs import get_config, get_smoke_config, input_specs
from repro_torch.configs.base import InputShape
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import make_host_mesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import lsh_attention as tl
from repro_torch.models import model_module
from repro_torch.serve.serve_step import lsh_shard_rule, make_decode_step, make_prefill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_LIMIT_S = 120
JAX_LIMIT_S = 240
WORLDS = (2, 4)
SHARDS = (2, 4, 8)
DTYPES = ("f32", "bf16")
STEP_ARCHS = ("yi_6b", "qwen3_moe_30b_a3b", "llama32_vision_11b")
PROMPT, MAX_SEQ, STEPS = 16, 32, 4
# a chunk of S tokens past the prompt on a sequence-split cache: the
# archs, the (data, model) meshes and the chunk lengths
CHUNK_ARCHS = ("yi_6b", "llama32_vision_11b")
CHUNK_MESHES = ((2, 1), (4, 1), (2, 2))
CHUNKS = (2, 7, 16)

# (B, H, KV, hd, m, Smax): the attention cases' shapes
SHAPE = (2, 4, 2, 16, 8, 64)
# name: (kv_len, topk, tied pk rows, axis)
LSH_CASES = {
    "ragged": (45, 16, False, "data"),  # kv_len not a multiple of any shard length
    "inside_shard0": (5, 16, False, "data"),  # every other shard all masked
    "small_topk": (50, 3, False, ("data", "model")),  # T < P and P ∤ T; a tuple axis
    "ties": (60, 12, True, "data"),  # rows of pk repeated
}
OVER_BUDGET = (60, 72)  # P = 8: ceil(72/8) = 9 > the shard length 8: both raise


def _lsh_inputs(tied: bool, seed: int = 0) -> dict:
    B, H, KV, hd, m, Smax = SHAPE
    r = np.random.default_rng(seed)
    x = {"q": r.normal(size=(B, 1, H, hd)), "k": r.normal(size=(B, Smax, KV, hd)),
         "v": r.normal(size=(B, Smax, KV, hd)), "a": r.normal(size=(hd, m))}
    pk = r.normal(size=(B, Smax, KV, m))
    if tied:  # every row of a block of 4 the same: ties within and across shards
        pk = np.repeat(pk[:, ::4], 4, axis=1)
    x["pk"] = pk
    return {k: v.astype(np.float32) for k, v in x.items()}


def _step_inputs(arch: str) -> dict:
    cfg = jax_smoke_config(arch)
    r = np.random.default_rng(3)
    out = {"tokens": r.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = (r.normal(size=(1, cfg.n_image_tokens, cfg.d_model))
                               * 0.1).astype(np.float32)
    return out


def _chunk(arch: str, S: int) -> np.ndarray:
    """The (1, S) block of tokens written past the prompt."""
    r = np.random.default_rng(40 + S)
    return r.integers(0, jax_smoke_config(arch).vocab_size, (1, S)).astype(np.int32)


_JAX = r"""
import functools
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_submesh
from repro.configs import get_smoke_config
from repro.models import lsh_attention as jl, model_module
from repro.serve.serve_step import make_decode_step, make_prefill
inp = dict(np.load(IN))
out = {}
DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

@functools.partial(jax.jit, static_argnames=("topk", "P"))
def positions(q, pk, a, kv_len, topk, P):
    # the reference's local scores, shard by shard, and lax.top_k on each
    B, _, H, hd = q.shape
    Smax, KV, m = pk.shape[1:]
    Sl, Tl = Smax // P, max(1, -(-topk // P))
    qp = jnp.einsum("bqhd,dm->bqhm", q, a, preferred_element_type=jnp.float32)
    qp_g = qp.reshape(B, KV, H // KV, -1).mean(axis=2)
    got = []
    for p in range(P):
        pkb = pk[:, p * Sl:(p + 1) * Sl]
        s = jnp.einsum("bskm,bkm->bsk", pkb, qp_g.astype(pkb.dtype),
                       preferred_element_type=jnp.float32)
        valid = (p * Sl + jnp.arange(Sl))[None, :, None] < kv_len
        s = jnp.where(valid, s, -jnp.inf)
        got.append(p * Sl + jax.lax.top_k(s.transpose(0, 2, 1), Tl)[1])
    return jnp.concatenate(got, axis=2)

for name, (kv_len, topk, axis) in CASES.items():
    for dt in ("f32", "bf16"):
        x = {k: jnp.asarray(inp[f"{name}_{k}"]).astype(DT[dt]) for k in ("q", "k", "v", "pk", "a")}
        for P in (2, 4, 8):
            mesh = make_submesh((P, 1), ("data", "model"))
            # jitted, as the reference's decode step runs it (an eager
            # shard_map compiles op by op: seconds a call)
            fn = jax.jit(functools.partial(jl.lsh_decode_attention_sharded, topk=topk,
                                           mesh=mesh, axis=axis))
            kv = jnp.int32(kv_len)
            o = fn(x["q"], x["k"], x["v"], x["pk"], x["a"], kv_len=kv)
            out[f"{name}_{dt}_{P}_out"] = np.asarray(o.astype(jnp.float32))
            out[f"{name}_{dt}_{P}_pos"] = np.asarray(
                positions(x["q"], x["pk"], x["a"], kv, topk=topk, P=P))
x = {k: jnp.asarray(inp[f"ragged_{k}"]) for k in ("q", "k", "v", "pk", "a")}
try:
    jl.lsh_decode_attention_sharded(x["q"], x["k"], x["v"], x["pk"], x["a"], kv_len=OVER[0],
                                    topk=OVER[1], mesh=make_submesh((8, 1), ("data", "model")))
    out["over_budget_raised"] = np.int64(0)
except ValueError:
    out["over_budget_raised"] = np.int64(1)

for arch in ARCHS:
    cfg = get_smoke_config(arch).replace(dtype=jnp.float32)
    params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
    b = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items() if k.startswith(arch + ":")}
    for P in (2, 4):
        mesh = make_submesh((P, 1), ("data", "model"))
        with mesh:
            pre, _ = make_prefill(cfg, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
            dec, _ = make_decode_step(cfg, mesh, batch=1, max_seq=MAX_SEQ)
            logits, caches = pre(params, b)
            steps, toks = [np.asarray(logits)], []
            for i in range(STEPS):
                t = np.asarray(logits).argmax(-1).astype(np.int32)
                toks.append(t)
                logits, caches = dec(params, caches, {**b, "tokens": jnp.asarray(t),
                                                      "position": jnp.int32(PROMPT + i)})
                steps.append(np.asarray(logits))
        out[f"{arch}_{P}_logits"] = np.concatenate(steps, axis=1)
        out[f"{arch}_{P}_tokens"] = np.concatenate(toks, axis=1)

# a chunk of S tokens past the prompt: the decode step on a (B, S) block
for arch in CHUNK_ARCHS:
    cfg = get_smoke_config(arch).replace(dtype=jnp.float32)
    params = model_module(cfg).init_params(cfg, jax.random.PRNGKey(0))
    b = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items() if k.startswith(arch + ":")}
    for D, M in CHUNK_MESHES:
        mesh = make_submesh((D, M), ("data", "model"))
        with mesh:
            pre, _ = make_prefill(cfg, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
            dec, _ = make_decode_step(cfg, mesh, batch=1, max_seq=MAX_SEQ)
            _, caches = pre(params, b)
            for S in CHUNKS:
                c = jax.tree.map(jnp.copy, caches)  # the step donates its caches
                lg, _ = dec(params, c, {**b, "tokens": jnp.asarray(inp[f"chunk{S}/{arch}"]),
                                        "position": jnp.int32(PROMPT)})
                out[f"{arch}_{D}x{M}_chunk{S}"] = np.asarray(lg)
np.savez(OUT, **out)
"""


def run_jax(code: str, inputs: dict, tmp, **consts) -> dict:
    """``code`` in one JAX subprocess with 8 forced CPU devices: it reads
    ``IN`` (``inputs``) and the names in ``consts``, and saves ``OUT``."""
    np.savez(tmp / "in.npz", **inputs)
    head = f"IN, OUT = {str(tmp / 'in.npz')!r}, {str(tmp / 'out.npz')!r}\n"
    head += "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", head + code], env=env, capture_output=True,
                          text=True, timeout=JAX_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def spawn_ranks(target, world: int, tmp, *args) -> list[dict]:
    """``target(rank, world, store, out_dir, *args)`` in ``world`` spawned
    processes, joined with a hard limit; each saves ``rank<r>.npz``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(tmp / "store"), str(tmp)) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_LIMIT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errs = "".join(f.read_text() for f in sorted(tmp.glob("rank*.err")))
    assert not hung, f"world {world}: {len(hung)} ranks still running after {SPAWN_LIMIT_S} s"
    assert all(p.exitcode == 0 for p in procs), errs[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def rank_main(fn, rank: int, world: int, store: str, out_dir: str, *args) -> None:
    """A rank's body: gloo over the file store, ``fn(*args)``'s arrays saved."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **fn(*args))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    inputs = {}
    for name, (_, _, tied, _) in LSH_CASES.items():
        inputs.update({f"{name}_{k}": v for k, v in _lsh_inputs(tied).items()})
    for arch in STEP_ARCHS:
        inputs.update({f"{arch}:{k}": v for k, v in _step_inputs(arch).items()})
    for arch in CHUNK_ARCHS:
        inputs.update({f"chunk{S}/{arch}": _chunk(arch, S) for S in CHUNKS})
    cases = {n: (kv, t, ax) for n, (kv, t, _, ax) in LSH_CASES.items()}
    return run_jax(_JAX, inputs, tmp_path_factory.mktemp("jax_lm_shard"), CASES=cases,
                   OVER=OVER_BUDGET, ARCHS=STEP_ARCHS, PROMPT=PROMPT, MAX_SEQ=MAX_SEQ,
                   STEPS=STEPS, CHUNK_ARCHS=CHUNK_ARCHS, CHUNK_MESHES=CHUNK_MESHES,
                   CHUNKS=CHUNKS)


# ---------------------------------------------------------------------------
# what the emulated mesh and each rank run
# ---------------------------------------------------------------------------

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
_STEP_PARAMS = {}


def _step_params(arch: str):
    if arch not in _STEP_PARAMS:
        jc = jax_smoke_config(arch).replace(dtype=jnp.float32)
        tc = get_smoke_config(arch).replace(dtype=torch.float32)
        jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
        _STEP_PARAMS[arch] = (tc, lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                                       device="cpu"))
    return _STEP_PARAMS[arch]


def _local(mesh, t: torch.Tensor) -> torch.Tensor:
    """The block of a sequence-split tensor this process holds."""
    dm = mesh.data
    if dm.emulated:
        return t
    Sl = t.shape[1] // dm.size
    return t[:, dm.rank * Sl:(dm.rank + 1) * Sl].contiguous()


def run_sharded(mesh, tokens: dict | None = None) -> dict:
    """The attention cases and the yi smoke steps on ``mesh`` (B = 1); the
    steps feed ``tokens`` (a step's greedy tokens), or their own argmax."""
    out, P = {}, mesh.data.size
    for name, (kv_len, topk, tied, axis) in LSH_CASES.items():
        x = {k: torch.from_numpy(v) for k, v in _lsh_inputs(tied).items()}
        for dt in DTYPES:
            y = {k: v.to(_DT[dt]) for k, v in x.items()}
            o, pos = tl.lsh_decode_attention_sharded(
                y["q"], *(_local(mesh, y[k]) for k in ("k", "v", "pk")), y["a"],
                kv_len=kv_len, topk=topk, mesh=mesh, axis=axis, return_positions=True)
            out[f"{name}_{dt}_out"], out[f"{name}_{dt}_pos"] = o.float().numpy(), pos.numpy()
    tc = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    params = model_module(tc).init_params(tc, 0, device="cpu")  # the port's own draws
    b = {k: torch.from_numpy(v) for k, v in _step_inputs("yi_6b").items()}
    pre, _ = make_prefill(tc, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
    dec, info = make_decode_step(tc, mesh, batch=1, max_seq=MAX_SEQ)
    logits, caches = pre(params, b)
    steps = [logits]
    for i in range(STEPS):
        t = (logits.argmax(-1).to(torch.int32) if tokens is None
             else torch.from_numpy(tokens[:, i:i + 1]))
        logits, caches = dec(params, caches, {"tokens": t, "position": PROMPT + i})
        steps.append(logits)
    out["steps_logits"] = torch.cat(steps, 1).numpy()
    out["cache_k0"] = caches[0]["k"].numpy()
    out["cache_pk1"] = caches[1]["pk"].numpy()
    out["form"] = np.array([P, int(info["lsh_shard"] is not None)])
    return out


def run_chunk(mesh, S: int = 7) -> dict:
    """yi's smoke config (the port's own draws) on ``mesh``: the prompt,
    then a chunk of S tokens past it; the chunk's logits and the blocks
    of layer 0's pk and layer 1's k this process holds (whole when
    emulated).  A group rank of a 2-D mesh holds its parameter blocks."""
    from repro_torch.serve.serve_step import step_form
    from repro_torch.train.train_step import shard_params

    tc = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    params = model_module(tc).init_params(tc, 0, device="cpu")
    form = step_form(tc, mesh, batch=1, max_seq=MAX_SEQ)
    if form["parallel"] and not mesh.emulated:
        shard_params(params, mesh, form["layouts"])
    b = {k: torch.from_numpy(v) for k, v in _step_inputs("yi_6b").items()}
    pre, _ = make_prefill(tc, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
    dec, _ = make_decode_step(tc, mesh, batch=1, max_seq=MAX_SEQ)
    _, caches = pre(params, b)
    lg, caches = dec(params, caches, {"tokens": torch.from_numpy(_chunk("yi_6b", S)),
                                      "position": PROMPT})
    tag = f"chunk{mesh.data.size}x{mesh.model.size}"
    return {f"{tag}_logits": lg.numpy(), f"{tag}_pk0": caches[0]["pk"].numpy(),
            f"{tag}_k1": caches[1]["k"].numpy()}


def run_forms(mesh, grid=None) -> dict:
    """What a (P, 1) mesh runs, and a chunk on the 2-D ``grid`` too."""
    out = run_sharded(mesh)
    out.update(run_chunk(mesh))
    if grid is not None:
        out.update(run_chunk(grid))
    return out


def _group_body():
    import torch.distributed as dist

    grid = make_host_mesh(2, device="cpu") if dist.get_world_size() == 4 else None
    return run_forms(make_host_mesh(device="cpu"), grid)


def _rank(rank, world, store, out_dir):
    rank_main(_group_body, rank, world, store, out_dir)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def group(request, tmp_path_factory):
    """(world, per-rank answers, the emulated mesh's answers)."""
    world = request.param
    ranks = spawn_ranks(_rank, world, tmp_path_factory.mktemp(f"gloo_lm{world}"))
    grid = make_host_mesh(2, data=2, device="cpu") if world == 4 else None
    return world, ranks, run_forms(make_host_mesh(data=world, device="cpu"), grid)


# ---------------------------------------------------------------------------
# lsh_decode_attention_sharded against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", list(LSH_CASES))
def test_sharded_lsh_attention_matches_jax(jax_side, name, dt, P):
    got = run_sharded_attention(name, dt, P)
    want = jax_side[f"{name}_{dt}_{P}_out"]
    np.testing.assert_array_equal(got["pos"], jax_side[f"{name}_{dt}_{P}_pos"])
    if dt == "f32":
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=1e-4 * np.abs(want).max())


def run_sharded_attention(name: str, dt: str, P: int) -> dict:
    kv_len, topk, tied, axis = LSH_CASES[name]
    y = {k: torch.from_numpy(v).to(_DT[dt]) for k, v in _lsh_inputs(tied).items()}
    o, pos = tl.lsh_decode_attention_sharded(
        y["q"], y["k"], y["v"], y["pk"], y["a"], kv_len=kv_len, topk=topk,
        mesh=make_host_mesh(data=P, device="cpu"), axis=axis, return_positions=True)
    return {"out": o.float().numpy(), "pos": pos.numpy()}


def test_masked_shards_stay_in_the_gathered_set(jax_side):
    """kv_len inside shard 0: the other shards' candidates are all masked,
    gathered with a False flag, and the answer is shard 0's softmax."""
    got = run_sharded_attention("inside_shard0", "f32", 8)
    kv_len = LSH_CASES["inside_shard0"][0]
    assert got["pos"].shape[-1] == 8 * 2 and (got["pos"][..., 2:] >= 8).all()
    assert (got["pos"][..., :2] < kv_len).all()
    B, H, KV, hd, _, _ = SHAPE
    x = {k: torch.from_numpy(v) for k, v in _lsh_inputs(False).items()}
    sel = torch.from_numpy(got["pos"][..., :2]).transpose(1, 2)[..., None].expand(B, 2, KV, hd)
    k, v = (torch.gather(x[n], 1, sel) for n in ("k", "v"))
    want = tl.lsh_attention_reference(x["q"], k, v, kv_len=2)  # shard 0's two, alone
    np.testing.assert_allclose(got["out"], want.numpy(), rtol=1e-6, atol=1e-7)


def test_budget_past_the_shard_length_raises_on_both_sides(jax_side):
    assert jax_side["over_budget_raised"] == 1
    kv_len, topk = OVER_BUDGET
    x = {k: torch.from_numpy(v) for k, v in _lsh_inputs(False).items()}
    with pytest.raises(ValueError, match=r"= 9 exceeds the shard length 8"):
        tl.lsh_decode_attention_sharded(x["q"], x["k"], x["v"], x["pk"], x["a"], kv_len=kv_len,
                                        topk=topk, mesh=make_host_mesh(data=8, device="cpu"))


@pytest.mark.parametrize("name", list(LSH_CASES))
def test_one_shard_is_the_unsharded_form_bit_for_bit(name):
    kv_len, topk, tied, axis = LSH_CASES[name]
    x = {k: torch.from_numpy(v) for k, v in _lsh_inputs(tied).items()}
    want = tl.lsh_decode_attention(x["q"], x["k"], x["v"], x["pk"], x["a"], kv_len=kv_len,
                                   topk=topk)
    got, pos = tl.lsh_decode_attention_sharded(
        x["q"], x["k"], x["v"], x["pk"], x["a"], kv_len=kv_len, topk=topk,
        mesh=make_host_mesh(device="cpu"), axis=axis, return_positions=True)
    assert torch.equal(got, want)
    assert torch.equal(pos, tl.lsh_select(x["q"], x["pk"], x["a"], kv_len=kv_len, topk=topk))


# ---------------------------------------------------------------------------
# the model steps on (P, 1) meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_prefill_and_decode_match_jax(jax_side, arch, P):
    tc, params = _step_params(arch)
    mesh = make_host_mesh(data=P, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _step_inputs(arch).items()}
    pre, pinfo = make_prefill(tc, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
    dec, dinfo = make_decode_step(tc, mesh, batch=1, max_seq=MAX_SEQ)
    assert pinfo["lsh_shard"] == dinfo["lsh_shard"] == ("data", "model")
    want, toks = jax_side[f"{arch}_{P}_logits"], jax_side[f"{arch}_{P}_tokens"]
    logits, caches = pre(params, b)
    got = [logits]
    for i in range(STEPS):
        logits, caches = dec(params, caches, {**b, "tokens": torch.from_numpy(toks[:, i:i + 1]),
                                              "position": PROMPT + i})
        got.append(logits)
    got = torch.cat(got, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _cfg(arch, **kw):
    return get_smoke_config(arch).replace(**kw)


@pytest.mark.parametrize("P", (1, 2, 4, 8))
def test_the_rule_picks_the_reference_form(P):
    mesh = make_host_mesh(data=P, device="cpu")
    yi = _cfg("yi_6b")
    sharded = None if P == 1 else ("data", "model")
    for batch, cfg, max_seq, want in (
            (1, yi, 32, sharded),  # batch ∤ P: the sequence split
            (P, yi, 32, None),  # the batch divides: the plain decode
            (1, _cfg("whisper_base"), 32, None),  # the encoder-decoder never
            (1, yi.replace(lsh_attention=False), 32, None),  # no PM-LSH, no tournament
            (1, _cfg("recurrentgemma_9b"), 32, None)):
        got = lsh_shard_rule(cfg, mesh, batch=batch, max_seq=max_seq)
        assert (got if got is None else got[1]) == want, (batch, cfg.name)
        fn, info = make_decode_step(cfg, mesh, batch=batch, max_seq=max_seq)
        assert info["lsh_shard"] == want
    if P > 1:  # the sequence must divide the data axis
        assert lsh_shard_rule(yi, mesh, batch=1, max_seq=32 * P + 1) is None


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("index", [0, 5, 7, 8, 14, 15, 30, -1, -9])
def test_block_writes_equal_the_whole_cache_write(index, S, as_tensor):
    """Each of 4 blocks of a 16-row cache written with ``base`` / ``total``
    holds, after the write, its rows of the whole cache's write (the
    reference's clamped start, taken over the whole cache)."""
    from repro_torch.models import layers as L

    r = np.random.default_rng(index % 7 + S)
    whole = torch.from_numpy(r.normal(size=(2, 16, 3)).astype(np.float32))
    new = torch.from_numpy(r.normal(size=(2, S, 3)).astype(np.float32))
    blocks = [whole[:, p * 4:(p + 1) * 4].clone() for p in range(4)]
    at = torch.tensor(index) if as_tensor else index
    L.write_rows(whole, new, at)
    for p, blk in enumerate(blocks):
        L.write_rows(blk, new, at, base=p * 4, total=16)
        assert torch.equal(blk, whole[:, p * 4:(p + 1) * 4]), p


def test_a_sequence_split_cache_refuses_a_chunk_past_position_0(jax_side):
    """``transformer.forward`` past position 0 with ``lsh_shard=(mesh,
    "data")`` on a cache split over 2 data shards, at an int and at a
    tensor position: the reference's answer, as its decode step gives
    it (the same forward), within 1e-4 of the largest logit."""
    from repro_torch.models import transformer as tt

    tc, params = _step_params("yi_6b")
    mesh = make_host_mesh(data=2, device="cpu")
    pre, _ = make_prefill(tc, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
    want = jax_side["yi_6b_2x1_chunk2"]
    for position in (PROMPT, torch.tensor(PROMPT)):
        _, caches = pre(params, {"tokens": torch.from_numpy(_step_inputs("yi_6b")["tokens"])})
        with torch.inference_mode():
            logits, _ = tt.forward(params, torch.from_numpy(_chunk("yi_6b", 2)), tc,
                                   caches=caches, position0=position,
                                   lsh_shard=(mesh, "data"))
        np.testing.assert_allclose(logits[:, -1:].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


_ONE_DEVICE = {}


def _one_device_chunk(arch: str, S: int):
    """The prompt and the chunk on one device: (last logits, caches)."""
    if (arch, S) not in _ONE_DEVICE:
        tc, params = _step_params(arch)
        b = {k: torch.from_numpy(v) for k, v in _step_inputs(arch).items()}
        one = make_host_mesh(device="cpu")
        pre, _ = make_prefill(tc, one, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
        dec, info = make_decode_step(tc, one, batch=1, max_seq=MAX_SEQ)
        assert info["lsh_shard"] is None
        _, caches = pre(params, b)
        _ONE_DEVICE[arch, S] = dec(params, caches, {**b, "tokens": torch.from_numpy(
            _chunk(arch, S)), "position": PROMPT})
    return _ONE_DEVICE[arch, S]


@pytest.mark.parametrize("S", CHUNKS)
@pytest.mark.parametrize("shape", CHUNK_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", CHUNK_ARCHS)
def test_a_chunk_past_the_prompt_matches_jax(jax_side, arch, shape, S):
    """``make_decode_step`` on a (1, S) block at position 16 over a cache
    split over 'data' ((P, 1)) or ('data', 'model') ((2, 2)): the
    reference's last logits within 1e-4 of the largest; layer 0, whose
    input is the embedding on every form, holds the one-device cache bit
    for bit, the chunk's rows included; the deeper layers' rows and the
    logits sit within 1e-4 of the one-device form's largest (an ordered
    merge of the shards' softmax partials against one pass)."""
    D, M = shape
    tc, params = _step_params(arch)
    mesh = make_host_mesh(M, data=D, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _step_inputs(arch).items()}
    pre, _ = make_prefill(tc, mesh, batch=1, seq_len=PROMPT, max_seq=MAX_SEQ)
    dec, info = make_decode_step(tc, mesh, batch=1, max_seq=MAX_SEQ)
    assert info["lsh_shard"] == ("data", "model")
    _, caches = pre(params, b)
    got, caches = dec(params, caches, {**b, "tokens": torch.from_numpy(_chunk(arch, S)),
                                       "position": PROMPT})
    assert tuple(got.shape) == (1, 1, tc.padded_vocab())
    want = jax_side[f"{arch}_{D}x{M}_chunk{S}"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    one, one_caches = _one_device_chunk(arch, S)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                               atol=1e-4 * float(one.abs().max()))
    for name, t in caches[0].items():
        assert torch.equal(t, one_caches[0][name]), name
    for c, oc in zip(caches[1:], one_caches[1:]):
        for name, t in c.items():
            np.testing.assert_allclose(t.numpy(), oc[name].numpy(), rtol=0,
                                       atol=1e-4 * float(oc[name].abs().max()))


def test_a_layer_without_lsh_on_a_split_cache_masks_global_positions():
    """recurrentgemma's local attention (window 8) over a cache split over
    2 data shards: the prompt, two one-token steps and a chunk of 7 past
    them equal the one-device forward within 1e-5 of the largest logit;
    without a cache ``lsh_shard`` does nothing, as in the reference."""
    from repro_torch.models import transformer as tt

    tc = _cfg("recurrentgemma_9b", dtype=torch.float32, window=8)
    mod = model_module(tc)
    params = mod.init_params(tc, 0, device="cpu")
    r = np.random.default_rng(9)
    blocks = [torch.from_numpy(r.integers(0, tc.vocab_size, (1, n)).astype(np.int32))
              for n in (PROMPT, 1, 1, 7)]
    mesh = make_host_mesh(data=2, device="cpu")
    logits = {}
    with torch.inference_mode():
        for shard in (None, (mesh, "data")):
            caches, pos, got = mod.init_cache(tc, 1, MAX_SEQ, device="cpu"), 0, []
            for tok in blocks:
                lg, caches = tt.forward(params, tok, tc, caches=caches, position0=pos,
                                        lsh_shard=shard)
                got.append(lg)
                pos += tok.shape[1]
            logits[shard is None] = torch.cat(got, 1)
        plain, _ = tt.forward(params, blocks[0], tc, remat="none")
        ignored, _ = tt.forward(params, blocks[0], tc, remat="none", lsh_shard=(mesh, "data"))
    want = logits[True]
    np.testing.assert_allclose(logits[False].numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(ignored, plain)


@pytest.mark.parametrize("P", WORLDS)
def test_a_chunk_moves_its_attention_partials_alone(P):
    """One abstract rank of a (P, 1) mesh (the dry run's) decoding a chunk
    of S tokens on yi's split cache: each layer all-gathers its shards'
    partials, B·S·H·(hd + 2) float32 a shard, and nothing else crosses."""
    from repro_torch.launch.mesh import CollectiveTally, make_abstract_mesh
    from repro_torch.serve.serve_step import fresh_caches

    tc, S = get_smoke_config("yi_6b"), 7
    tally = CollectiveTally()
    mesh = make_abstract_mesh(P, 1, tally=tally)
    dec, info = make_decode_step(tc, mesh, batch=1, max_seq=MAX_SEQ)
    caches = fresh_caches(tc, mesh, batch=1, max_seq=MAX_SEQ)
    assert caches[0]["k"].shape[1] == MAX_SEQ // P
    tokens = torch.empty((1, S), dtype=torch.int32, device="meta")
    logits, _ = dec(info["abstract_params"], caches, {"tokens": tokens, "position": PROMPT})
    assert tuple(logits.shape) == (1, 1, tc.padded_vocab())
    per_shard = 1 * S * tc.n_heads * (tc.head_dim + 2) * 4
    assert tally.bytes["all-gather"] == tc.n_layers * P * per_shard
    assert tally.counts["all-gather"] == tc.n_layers
    assert sum(tally.bytes.values()) == tally.bytes["all-gather"]


# ---------------------------------------------------------------------------
# the group form: each rank holds its blocks, the answers are the emulated ones
# ---------------------------------------------------------------------------


def test_group_attention_equals_emulated(group):
    world, ranks, emulated = group
    keys = [k for k in emulated if k.endswith(("_out", "_pos"))]
    for out in ranks:
        for k in keys:
            np.testing.assert_array_equal(out[k], emulated[k], err_msg=k)


def test_group_steps_equal_emulated_and_hold_only_their_blocks(group):
    world, ranks, emulated = group
    Sl = MAX_SEQ // world
    for r, out in enumerate(ranks):
        assert out["form"].tolist() == [world, 1]
        np.testing.assert_array_equal(out["steps_logits"], emulated["steps_logits"])
        assert out["cache_k0"].shape[1] == Sl
        np.testing.assert_array_equal(out["cache_k0"],
                                      emulated["cache_k0"][:, r * Sl:(r + 1) * Sl])
        np.testing.assert_array_equal(out["cache_pk1"],
                                      emulated["cache_pk1"][:, r * Sl:(r + 1) * Sl])


def test_group_chunk_equals_emulated_on_its_blocks(group):
    """A chunk past the prompt on gloo ranks of (P, 1), and of (2, 2) in a
    world of 4: each rank's logits the emulated form's bit for bit, its
    cache blocks the emulated cache's rows (data-major over the world)."""
    world, ranks, emulated = group
    tags = [f"chunk{world}x1"] + (["chunk2x2"] if world == 4 else [])
    Sl = MAX_SEQ // world
    for r, out in enumerate(ranks):
        for tag in tags:
            np.testing.assert_array_equal(out[f"{tag}_logits"], emulated[f"{tag}_logits"])
            for leaf in ("pk0", "k1"):
                assert out[f"{tag}_{leaf}"].shape[1] == Sl
                np.testing.assert_array_equal(
                    out[f"{tag}_{leaf}"], emulated[f"{tag}_{leaf}"][:, r * Sl:(r + 1) * Sl],
                    err_msg=f"rank {r}: {tag}_{leaf}")


# ---------------------------------------------------------------------------
# the specs, against the reference's on duck-typed meshes
# ---------------------------------------------------------------------------

MESHES = {"1x1": (("data", "model"), (1, 1)), "2x1": (("data", "model"), (2, 1)),
          "4x1": (("data", "model"), (4, 1)), "8x1": (("data", "model"), (8, 1)),
          "4x2": (("data", "model"), (4, 2)), "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _mesh_like(name):
    names, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _specs_tuple(tree):
    """The reference's spec tree with each PartitionSpec as a tuple."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _specs_tuple(v) for k, v in tree.items()}
    return type(tree)(_specs_tuple(v) for v in tree)


def _layers(cfg, tree, stacked) -> list[dict]:
    """One dict a layer from the reference's stacked cache or spec tree;
    ``stacked`` drops a leaf's stacked dimension."""
    if cfg.family == "encdec":
        return [{n: stacked(v, i) for part in ("self", "cross") for n, v in tree[part].items()}
                for i in range(cfg.n_layers)]
    from repro.models import transformer as jt

    unit, n_units, _ = jt.layer_plan(cfg)
    out = [{k: stacked(v, u) for k, v in tree["unit"][i].items()}
           for u in range(n_units) for i in range(len(unit))]
    return out + [dict(c) for c in tree["rest"]]


def _port_layers(caches) -> list[dict]:
    if isinstance(caches, dict):
        return [{**s, **c} for s, c in zip(caches["self"], caches["cross"])]
    return caches


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jcb.list_archs())
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    m = _mesh_like(mesh)
    jc, tc = jax_config(arch), get_config(arch)
    for batch in (1, 16):
        for max_seq in (32, jcb.SHAPES["long_500k"].seq_len):
            jspecs = jax_model_module(jc).cache_specs(jc, batch, max_seq)
            want = _specs_tuple(jsh.cache_pspecs(jspecs, m, batch=batch, max_seq=max_seq))
            # the port's rule on the reference's own tree: the same tree
            assert tsh.cache_pspecs(jspecs, m, batch=batch, max_seq=max_seq) == want
            # and on the port's cache, layer by layer (a stacked leaf's spec
            # without its leading None)
            tspecs = tsh.cache_pspecs(model_module(tc).cache_specs(tc, batch, max_seq), m,
                                      batch=batch, max_seq=max_seq)
            stacked = _layers(jc, want, lambda s, i: s[1:])
            assert _port_layers(tspecs) == stacked
            for kind in ("train", "prefill", "decode"):
                shape = InputShape(kind, max_seq, batch, kind)
                jb = jsh.batch_pspecs(jcb.input_specs(jc, shape), m)
                assert tsh.batch_pspecs(input_specs(tc, shape), m) == _specs_tuple(jb)


def test_local_shape_reads_a_spec_as_a_named_sharding():
    m = _mesh_like("2x16x16")
    assert tsh.split_dims((None, ("data", "model"), None, None), m) == {1: 256}
    assert tsh.local_shape((1, 524288, 4, 128), (None, ("data", "model"), None, None), m) \
        == (1, 2048, 4, 128)
    assert tsh.local_shape((64, 32), (("pod", "data"), "model"), m) == (2, 2)
    assert tsh.split_dims((None, "model"), _mesh_like("4x1")) == {}
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_shape((3, 8), ("data", None), _mesh_like("2x1"))
