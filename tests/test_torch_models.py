"""The port's LM (``repro_torch.configs``, ``repro_torch.models``) held
against ``repro.configs`` and ``repro.models`` on the same numpy inputs,
with the JAX parameters carried across by
``convert.lm_params_from_numpy``.

Tolerances (float32 unless said):

* layer functions agree to 1e-6 (rtol and atol): the same arithmetic,
  summed in another order by the two frameworks;
* ``rope`` at positions past 4,000 agrees to 5e-4·max|x|: an ulp of
  difference between the frameworks' float32 ``pow`` in ``freq`` grows
  to ≈ 2.5e-4 rad of angle at position 4096;
* logits agree to 1e-4 relative to the largest logit, and every layer's
  cache (k, v, pk) to 1e-5 relative to its largest entry, through 2–4
  layers of 1e-7 roundings;
* the one bfloat16 case (the smoke configs' own dtype): relative L2
  error ≤ 0.03 and max |Δ| ≤ 0.05·max|logit| — the two frameworks round
  bfloat16 at other places (XLA's CPU fusions against torch's per-op
  rounding), ≈ 0.01 relative measured;
* the selected LSH ids and the MoE routing are identical, ties included
  (both break ties toward the lowest index).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import flash_attention as jflash
from repro.models import layers as jL
from repro.models import lsh_attention as jlsh
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.configs import base as tcb
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import flash_attention as tflash
from repro_torch.models import layers as tL
from repro_torch.models import lsh_attention as tlsh
from repro_torch.models import model_module
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

ARCHS = jcb.list_archs()
# the dense, moe and vlm families: the archs this slice serves
LM_ARCHS = ["yi_6b", "deepseek_67b", "mistral_large_123b", "minitron_8b",
            "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "llama32_vision_11b"]
CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), CPU)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _configs(arch, dtype="f32"):
    jc, tc = jcb.get_smoke_config(arch), tcb.get_smoke_config(arch)
    if dtype == "f32":
        jc, tc = jc.replace(dtype=jnp.float32), tc.replace(dtype=torch.float32)
    return jc, tc


def _tree(params):
    return jax.tree.map(np.asarray, params)


_PARAMS = {}


def _params(arch, dtype="f32"):
    """(jax cfg, port cfg, jax params, port params) of a smoke config."""
    if (arch, dtype) not in _PARAMS:
        jc, tc = _configs(arch, dtype)
        jp = jt.init_params(jc, jax.random.PRNGKey(0))
        _PARAMS[arch, dtype] = (jc, tc, jp, lm_params_from_numpy(tc, _tree(jp), device="cpu"))
    return _PARAMS[arch, dtype]


def _layer_caches(cfg, caches) -> list[dict]:
    """The reference's cache tree (stacked unit leaves + rest) as one dict
    a layer, in layer order."""
    unit, n_units, rest = jt.layer_plan(cfg)
    out = [{k: np.asarray(v[u]) for k, v in caches["unit"][i].items()}
           for u in range(n_units) for i in range(len(unit))]
    return out + [{k: np.asarray(v) for k, v in c.items()} for c in caches["rest"]]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    """The reference's table of published hyperparameters, on the port."""
    cfg = tcb.get_config(arch)
    expected = {
        "qwen3_moe_30b_a3b": (48, 2048, 32, 4, 151936),
        "qwen2_moe_a2_7b": (24, 2048, 16, 16, 151936),
        "deepseek_67b": (95, 8192, 64, 8, 102400),
        "yi_6b": (32, 4096, 32, 4, 64000),
        "mistral_large_123b": (88, 12288, 96, 8, 32768),
        "minitron_8b": (32, 4096, 32, 8, 256000),
        "llama32_vision_11b": (40, 4096, 32, 8, 128256),
        "recurrentgemma_9b": (38, 4096, 16, 1, 256000),
        "xlstm_125m": (12, 768, 4, 4, 50304),
        "whisper_base": (6, 512, 8, 8, 51865),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size)
    assert got == expected, f"{arch}: {got} != {expected}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_and_counts_match_reference(arch, which):
    get_j = jcb.get_config if which == "full" else jcb.get_smoke_config
    get_t = tcb.get_config if which == "full" else tcb.get_smoke_config
    jc, tc = get_j(arch), get_t(arch)
    jf, tf = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert jf.pop("dtype") == jnp.bfloat16 and tf.pop("dtype") == torch.bfloat16
    assert jf == tf
    for active in (False, True):
        assert tc.param_count(active) == jc.param_count(active)
    assert tc.padded_vocab() == jc.padded_vocab()
    assert tc.padded_experts() == jc.padded_experts()
    assert tc.sub_quadratic == jc.sub_quadratic
    alias = arch.replace("_", "-")
    assert get_t(alias) == tc  # "yi-6b" names yi_6b, as in the reference


def test_registry_and_shapes_match_reference():
    assert tcb.list_archs() == jcb.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in tcb.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jcb.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_meta_tensors_of_the_reference_shapes(arch):
    tc, jc = tcb.get_config(arch), jcb.get_config(arch)
    for name, shape in tcb.SHAPES.items():
        got = tcb.input_specs(tc, shape)
        want = jcb.input_specs(jc, jcb.SHAPES[name])
        assert set(got) == set(want)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape)
            assert str(spec.dtype).split(".")[-1] == str(want[key].dtype)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(tL.rms_norm(_t(x), _t(w), 1e-6), jL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 5e5, 5e6])
@pytest.mark.parametrize("offset", [0, 47, 4032])
def test_rope_matches_jax(theta, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 64)).astype(np.float32)
    pos = (np.arange(16) + offset).astype(np.int32)
    want = jL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tL.rope(_t(x), _t(pos), theta)
    if offset + 16 <= 64:
        _close(got, want)
    else:  # an ulp of freq grows to ≈ 2.5e-4 rad by position 4096
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=5e-4 * float(np.abs(x).max()))


def _qkv(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


CHUNKED_CASES = {
    # name: (Sq, Sk, kwargs)
    "causal_padded": (40, 40, {}),
    "not_causal": (24, 40, {"causal": False}),
    "kv_len": (1, 48, {"q_offset": 29, "kv_len": 30}),
    "q_offset_kv_len": (5, 24, {"q_offset": 10, "kv_len": 15}),
    "window": (40, 40, {"window": 8}),
    "window_decode": (1, 48, {"q_offset": 40, "kv_len": 41, "window": 8}),
}


@pytest.mark.parametrize("name", sorted(CHUNKED_CASES))
def test_chunked_attention_matches_jax(name):
    Sq, Sk, kw = CHUNKED_CASES[name]
    q, k, v = _qkv(2, Sq, Sk, 4, 2, 16, seed=len(name))
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16, **kw)
    got = tL.chunked_attention(_t(q), _t(k), _t(v), chunk=16, **kw)
    _close(got, want)
    # 0-d tensors for the offsets (the decode step's position) give the same
    tkw = {key: (torch.tensor(val) if key in ("q_offset", "kv_len") else val)
           for key, val in kw.items()}
    assert torch.equal(tL.chunked_attention(_t(q), _t(k), _t(v), chunk=16, **tkw), got)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_flash_forward_matches_jax(causal, window):
    q, k, v = _qkv(2, 64, 64, 4, 2, 16, seed=3)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal, window, 16)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal, window, 16)
    _close(got, want)
    with pytest.raises(ValueError, match="chunk"):
        tflash.flash_attention(_t(q), _t(k[:, :60]), _t(v[:, :60]), causal, window, 16)


def _attention_params(cfg_j, cfg_t, seed=0):
    jp = jL.init_attention(jax.random.PRNGKey(seed), cfg_j)
    return jp, {name: _t(a) for name, a in _tree(jp).items()}


ATTENTION_CASES = {
    # name: (S, Smax, cache_index, use_lsh)
    "no_cache": (8, None, 0, False),
    "prefill": (8, 12, 0, False),
    "decode_dense": (1, 12, 8, False),
    "decode_lsh": (1, 12, 8, True),
    "clamped_write": (4, 12, 10, False),  # start clamped to Smax - S = 8
    "clamped_decode_lsh": (1, 12, 14, True),  # start clamped to 11
}


@pytest.mark.parametrize("name", sorted(ATTENTION_CASES))
def test_attention_apply_with_cache_matches_jax(name):
    S, Smax, index, use_lsh = ATTENTION_CASES[name]
    jc, tc = _configs("yi_6b")
    jp, tp = _attention_params(jc, tc)
    rng = np.random.default_rng(4)
    B, KV, hd, m = 2, jc.n_kv_heads, jc.head_dim, jc.lsh_m
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = (index + np.arange(S)).astype(np.int32)
    jcache = tcache = None
    if Smax is not None:
        filled = {"k": rng.normal(size=(B, Smax, KV, hd)), "v": rng.normal(size=(B, Smax, KV, hd)),
                  "pk": rng.normal(size=(B, Smax, KV, m))}
        jcache = {n: jnp.asarray(a, jnp.float32) for n, a in filled.items()}
        tcache = {n: torch.tensor(a, dtype=torch.float32) for n, a in filled.items()}
    want, wcache = jL.attention_apply(jp, jnp.asarray(x), jc, positions=jnp.asarray(pos),
                                      cache=jcache, cache_index=index, use_lsh=use_lsh)
    got, gcache = tL.attention_apply(tp, _t(x), tc, positions=_t(pos), cache=tcache,
                                     cache_index=index, use_lsh=use_lsh)
    _close(got, want)
    if Smax is None:
        return
    assert gcache is tcache  # written in place
    for n in ("k", "v", "pk"):
        _close(gcache[n], wcache[n], 1e-5)
    if name.startswith("clamped"):  # nothing past the end; the clamped rows hold the new keys
        start = Smax - S
        k_new = _np(gcache["k"])[:, start:]
        assert not np.allclose(k_new, _np(jcache["k"])[:, start:])
    # a 0-d tensor index writes the same rows and answers the same
    tcache2 = {n: torch.tensor(np.asarray(a), dtype=torch.float32) for n, a in jcache.items()}
    got2, _ = tL.attention_apply(tp, _t(x), tc, positions=_t(pos), cache=tcache2,
                                 cache_index=torch.tensor(index), use_lsh=use_lsh)
    assert torch.equal(got2, got)
    for n in tcache2:
        assert torch.equal(tcache2[n], gcache[n])


def test_write_rows_clamps_like_dynamic_update_slice():
    buf = np.zeros((1, 6, 1, 2), np.float32)
    new = np.ones((1, 3, 1, 2), np.float32)
    for index in (-8, -2, 0, 2, 3, 5, 9):
        want = np.asarray(jax.lax.dynamic_update_slice_in_dim(jnp.asarray(buf),
                                                              jnp.asarray(new), index, axis=1))
        for idx in (index, torch.tensor(index)):
            got = torch.zeros(buf.shape)
            tL.write_rows(got, torch.ones(new.shape), idx)
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="rows"):
        tL.write_rows(torch.zeros(1, 2, 1, 2), torch.ones(1, 3, 1, 2), 0)


def test_cross_attention_matches_jax():
    jc, tc = _configs("llama32_vision_11b")
    jp = jL.init_cross_attention(jax.random.PRNGKey(2), jc)
    tp = {n: _t(a) for n, a in _tree(jp).items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, jc.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, jc.n_image_tokens, jc.d_model)).astype(np.float32)
    _close(tL.cross_attention_apply(tp, _t(x), _t(mem), tc),
           jL.cross_attention_apply(jp, jnp.asarray(x), jnp.asarray(mem), jc))


def test_swiglu_matches_jax():
    jp = jL.init_swiglu(jax.random.PRNGKey(3), 64, 96, jnp.float32)
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    _close(tL.swiglu_apply({n: _t(a) for n, a in _tree(jp).items()}, _t(x)),
           jL.swiglu_apply(jp, jnp.asarray(x)))


def test_gelu_mlp_is_the_tanh_form_and_matches_jax():
    jp = jL.init_gelu_mlp(jax.random.PRNGKey(4), 64, 96, jnp.float32)
    tp = {n: _t(a) for n, a in _tree(jp).items()}
    x = np.random.default_rng(7).normal(size=(2, 5, 64)).astype(np.float32)
    got = tL.gelu_mlp_apply(tp, _t(x))
    _close(got, jL.gelu_mlp_apply(jp, jnp.asarray(x)))
    erf = torch.nn.functional.gelu(_t(x) @ tp["w_in"]) @ tp["w_out"]
    assert float((erf - got).abs().max()) > 1e-6  # the erf form differs


def test_init_draws_from_the_generator():
    cfg = tcb.get_smoke_config("yi_6b")
    a, b, c = (tt.init_params(cfg, s, device="cpu") for s in (0, 0, 1))
    for (name, pa), (_, pb), (_, pc) in zip(a.named_parameters(), b.named_parameters(),
                                            c.named_parameters()):
        assert torch.equal(pa, pb), name
        if not name.endswith(("ln1", "ln2", "final_norm")):
            assert not torch.equal(pa, pc), name
    assert a.blocks[0]["attn"]["lsh_a"].shape == (cfg.head_dim, cfg.lsh_m)
    assert a.blocks[0]["ln1"].dtype == torch.float32 and a.embed.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_top_k_ties_go_to_the_lowest_index_like_lax():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 4, size=(5, 37)).astype(np.float32)
    x[1, 20:] = -np.inf
    x[2] = -np.inf
    for k in (1, 3, 10, 37):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tlsh.top_k_lowest_index(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "qwen3_moe_30b_a3b"])
@pytest.mark.parametrize("capacity_factor", [None, 1.0])
@pytest.mark.parametrize("tie", [False, True])
def test_moe_apply_matches_jax(arch, capacity_factor, tie):
    """At the smoke configs (dropless) and at a capacity that drops
    tokens; ``tie`` makes expert 2's router column expert 1's, so every
    token's logits tie between them and the lowest index must win."""
    jc, tc = _configs(arch)
    if capacity_factor is not None:
        jc, tc = jc.replace(capacity_factor=capacity_factor), tc.replace(
            capacity_factor=capacity_factor)
    jp = _tree(jmoe.init_moe(jax.random.PRNGKey(5), jc))
    if tie:
        jp["router"] = jp["router"].copy()
        jp["router"][:, 2] = jp["router"][:, 1]
    tp = tmoe.Params(**{n: (tmoe.Params(**{kk: _t(vv) for kk, vv in a.items()})
                            if isinstance(a, dict) else _t(a)) for n, a in jp.items()})
    x = np.random.default_rng(9).normal(size=(2, 8, jc.d_model)).astype(np.float32)
    if tie:  # the tie holds in both frameworks' logits
        jl = np.asarray(jnp.asarray(x.reshape(16, -1)) @ jnp.asarray(jp["router"]))
        tl = (_t(x).reshape(16, -1) @ tp["router"]).numpy()
        assert np.array_equal(jl[:, 1], jl[:, 2]) and np.array_equal(tl[:, 1], tl[:, 2])
    want = jmoe.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jc)
    _close(tmoe.moe_apply(tp, _t(x), tc), want, 1e-5)


def test_moe_capacity_matches_jax():
    for tokens, e, k, f in [(16, 6, 2, 8.0), (16, 8, 2, 1.0), (3, 60, 4, 1.25), (4096, 128, 8, 1.25)]:
        assert tmoe._capacity(tokens, e, k, f) == jmoe._capacity(tokens, e, k, f)


# ---------------------------------------------------------------------------
# PM-LSH decode attention: the reference's cases (test_lsh_attention.py)
# on the port, at their own thresholds, then against JAX
# ---------------------------------------------------------------------------


def _setup(B=2, S=512, KV=4, G=2, hd=32, m=16, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    H = KV * G
    q = torch.tensor(rng.normal(size=(B, 1, H, hd)), dtype=torch.float32) * q_scale
    k = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32)
    a = torch.tensor(rng.normal(size=(hd, m)), dtype=torch.float32)
    pk = torch.einsum("bskd,dm->bskm", k, a)
    return q, k, v, pk, a


def _rel(got, want) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def test_lsh_full_budget_matches_dense():
    q, k, v, pk, a = _setup(S=128)
    got = tlsh.lsh_decode_attention(q, k, v, pk, a, kv_len=128, topk=128)
    want = tlsh.lsh_attention_reference(q, k, v, kv_len=128)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_lsh_partial_budget_close_to_dense():
    q, k, v, pk, a = _setup(S=512, G=1, m=32, q_scale=3.0)
    got = tlsh.lsh_decode_attention(q, k, v, pk, a, kv_len=512, topk=256)
    want = tlsh.lsh_attention_reference(q, k, v, kv_len=512)
    assert _rel(got, want) < 0.15


def test_lsh_error_decreases_with_budget():
    q, k, v, pk, a = _setup(S=512, G=1, m=32, q_scale=3.0)
    want = tlsh.lsh_attention_reference(q, k, v, kv_len=512)
    errs = [_rel(tlsh.lsh_decode_attention(q, k, v, pk, a, kv_len=512, topk=T), want)
            for T in (64, 128, 256, 512)]
    assert all(x >= y - 0.02 for x, y in zip(errs, errs[1:])), errs
    assert errs[-1] < 1e-5


def test_lsh_respects_kv_len():
    q, k, v, pk, a = _setup(S=256)
    k[:, 128:] = 1e3
    v[:, 128:] = 1e3
    pk = torch.einsum("bskd,dm->bskm", k, a)
    got = tlsh.lsh_decode_attention(q, k, v, pk, a, kv_len=128, topk=64)
    assert bool(torch.isfinite(got).all())
    assert float(got.abs().max()) < 100.0


def test_lsh_candidate_recall_vs_topscore():
    q, k, v, pk, a = _setup(S=1024, KV=2, G=1, m=32, seed=3, q_scale=3.0)
    cand = tlsh.lsh_select(q, pk, a, kv_len=1024, topk=256)  # (B, KV, T)
    scores = torch.einsum("bqhd,bskd->bhs", q, k)
    best = tlsh.top_k_lowest_index(scores, 32)[1]
    cover = [len(set(cand[b, h].tolist()) & set(best[b, h].tolist())) / 32
             for b in range(q.shape[0]) for h in range(k.shape[2])]
    assert np.mean(cover) > 0.5, np.mean(cover)


def test_lsh_grouped_queries():
    q, k, v, pk, a = _setup(S=256, KV=2, G=4, m=32, q_scale=2.0)
    got = tlsh.lsh_decode_attention(q, k, v, pk, a, kv_len=256, topk=192)
    want = tlsh.lsh_attention_reference(q, k, v, kv_len=256)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) < 0.5


def _jax_select(q, pk, a, kv_len, T):
    """The reference's estimate and ``lax.top_k`` (lsh_attention.py:45-53),
    which it does not return on its own."""
    B, _, H, _ = q.shape
    _, Smax, KV, m = pk.shape
    qp = jnp.einsum("bqhd,dm->bqhm", q.astype(jnp.float32), a.astype(jnp.float32))
    qp_g = qp.reshape(B, KV, H // KV, m).mean(axis=2)
    est = jnp.einsum("bskm,bkm->bsk", pk.astype(jnp.float32), qp_g)
    est = jnp.where(jnp.arange(Smax)[None, :, None] < kv_len, est, -jnp.inf)
    return np.asarray(jax.lax.top_k(est.transpose(0, 2, 1), min(T, Smax))[1])


LSH_JAX_CASES = {
    # name: (S, kv_len, T, tied pk rows, pk dtype)
    "pruned": (96, 90, 40, False, "f32"),
    "T_over_kv_len": (64, 40, 56, False, "f32"),  # the masked −inf rows tie
    "T_over_smax": (48, 48, 64, False, "f32"),
    "tied_rows": (96, 96, 37, True, "f32"),  # 8 distinct pk rows, 12 copies each
    "tied_rows_bf16": (96, 70, 45, True, "bf16"),
    "bf16_pk": (96, 96, 50, False, "bf16"),  # equal bf16 estimates tie
}


@pytest.mark.parametrize("name", sorted(LSH_JAX_CASES))
def test_lsh_selection_and_output_match_jax(name):
    S, kv_len, T, tied, pk_dtype = LSH_JAX_CASES[name]
    rng = np.random.default_rng(S + T)
    B, KV, G, hd, m = 2, 2, 3, 16, 8
    q = rng.normal(size=(B, 1, KV * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    a = rng.normal(size=(hd, m)).astype(np.float32)
    pk = np.einsum("bskd,dm->bskm", k, a).astype(np.float32)
    if tied:
        pk = pk[:, np.arange(S) % 8]
    jpk = jnp.asarray(pk, jnp.bfloat16 if pk_dtype == "bf16" else jnp.float32)
    tpk = _t(np.asarray(jpk))
    want_ids = _jax_select(jnp.asarray(q), jpk, jnp.asarray(a), kv_len, T)
    got_ids = tlsh.lsh_select(_t(q), tpk, _t(a), kv_len=kv_len, topk=T)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    want = jlsh.lsh_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpk,
                                     jnp.asarray(a), kv_len=kv_len, topk=T)
    got = tlsh.lsh_decode_attention(_t(q), _t(k), _t(v), tpk, _t(a), kv_len=kv_len, topk=T)
    _close(got, want)
    ref = tlsh.lsh_attention_reference(_t(q), _t(k), _t(v), kv_len=kv_len)
    _close(ref, jlsh.lsh_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              kv_len=kv_len))
    if T >= kv_len:  # every valid key a candidate: the dense answer
        _close(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# the whole model at the smoke configs
# ---------------------------------------------------------------------------


def _memory(cfg, B, rng):
    if cfg.family != "vlm":
        return None
    return (rng.normal(size=(B, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)


def _logits_close(got, want, tol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_layout_and_count_match_jax(arch):
    jc, tc, jp, tp = _params(arch)
    leaves = jax.tree.leaves(jp)
    assert sum(p.numel() for p in tp.parameters()) == sum(x.size for x in leaves)
    own = tt.init_params(tc, 0, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in tt.abstract_params(tc).named_parameters()]
    assert all(p.device.type == "meta" for p in tt.abstract_params(tc).parameters())
    # cache layout: the reference's spec, one dict a layer
    want = _layer_caches(jc, jt.init_cache(jc, 2, 24))
    got = tt.cache_specs(tc, 2, 24)
    assert [{n: tuple(t.shape) for n, t in c.items()} for c in got] == [
        {n: tuple(t.shape) for n, t in c.items()} for c in want]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("logits_slice", ["all", "last", "hidden"])
def test_forward_matches_jax(arch, logits_slice):
    jc, tc, jp, tp = _params(arch)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    mem = _memory(jc, 2, rng)
    want, _ = jt.forward(jp, jnp.asarray(tok), jc, logits_slice=logits_slice,
                         memory=None if mem is None else jnp.asarray(mem))
    got, caches = tt.forward(tp, _t(tok), tc, logits_slice=logits_slice,
                             memory=None if mem is None else _t(mem))
    assert caches is None and got.dtype == torch.float32
    assert got.shape == want.shape
    _logits_close(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 32 tokens into a 40-row cache, then 4 decode steps: past
    the smoke configs' T = 32, so PM-LSH selects from kv_len 33–36."""
    jc, tc, jp, tp = _params(arch)
    rng = np.random.default_rng(12)
    B, S, Smax = 2, 32, 40
    tok = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    mem = _memory(jc, B, rng)
    jb = {"tokens": jnp.asarray(tok)}
    tb = {"tokens": _t(tok)}
    if mem is not None:
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(mem), _t(mem)
    want, jcaches = jt.prefill(jp, jb, jc, max_seq=Smax)
    got, tcaches = tt.prefill(tp, tb, tc, max_seq=Smax)
    _logits_close(got, want)
    for step in range(4):
        for layer, (g, w) in enumerate(zip(tcaches, _layer_caches(jc, jcaches))):
            assert set(g) == set(w)
            for n in w:
                np.testing.assert_allclose(_np(g[n]), w[n], rtol=0,
                                           atol=1e-5 * float(np.abs(w[n]).max()),
                                           err_msg=f"step {step} layer {layer} {n}")
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, dim=-1).numpy(), nxt)
        jb = {**jb, "tokens": jnp.asarray(nxt), "position": jnp.int32(S + step)}
        tb = {**tb, "tokens": _t(nxt), "position": S + step}
        want, jcaches = jt.decode_step(jp, jcaches, jb, jc)
        got, tcaches = tt.decode_step(tp, tcaches, tb, tc)
        _logits_close(got, want)


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_moe_30b_a3b"])
def test_bf16_forward_matches_jax(arch):
    jc, tc, jp, tp = _params(arch, "bf16")
    assert tp.embed.dtype == torch.bfloat16 and tp.blocks[0]["ln1"].dtype == torch.float32
    tok = np.random.default_rng(13).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(tok), jc)[0])
    got = tt.forward(tp, _t(tok), tc)[0].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 0.03
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_consistency_with_prefill(arch):
    """The reference's smoke check on the port: teacher-forced decode after
    prefill ≈ the full forward's last logits (corr > 0.98), at the smoke
    configs' own dtype."""
    cfg = tcb.get_smoke_config(arch)
    mod = model_module(cfg)
    params = mod.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    B, S = 1, 8
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    mem = None
    if cfg.family == "vlm":
        mem = torch.ones((B, cfg.n_image_tokens, cfg.d_model), dtype=cfg.dtype) * 0.01
    full, _ = mod.forward(params, tok, cfg, memory=mem)
    caches = mod.init_cache(cfg, B, S, device="cpu")
    _, caches = mod.forward(params, tok[:, : S - 1], cfg, caches=caches, memory=mem)
    step = {"tokens": tok[:, S - 1:], "position": torch.tensor(S - 1, dtype=torch.int32)}
    if mem is not None:
        step["image_embeds"] = mem
    dec, _ = mod.decode_step(params, caches, step, cfg)
    corr = np.corrcoef(full[:, -1].numpy().ravel(), dec[:, -1].numpy().ravel())[0, 1]
    assert corr > 0.98, corr


def test_forward_rejects_what_the_reference_cannot_run():
    cfg = tcb.get_smoke_config("yi_6b")
    params = tt.init_params(cfg, 0, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="logits_slice"):
        tt.forward(params, tok, cfg, logits_slice="first")
    with pytest.raises(ValueError, match="layer caches"):
        tt.forward(params, tok, cfg, caches=tt.init_cache(cfg, 1, 4, device="cpu")[:1])
