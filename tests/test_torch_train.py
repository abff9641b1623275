"""The port's training path (flash attention's backward, the chunked
attention's gradients, the losses, every smoke config's gradients, the
remat modes, AdamW, the train step and the data pipeline) held against
``repro.models``, ``repro.train`` and ``repro.data.pipeline`` on the
same numpy inputs, with the JAX parameters carried across by
``convert.lm_params_from_numpy`` and the port's gradients mapped back
onto the reference's tree by ``convert.lm_params_to_numpy``.  The
reference runs as its own tests run it: ``jax.vjp`` / ``jax.grad``
under ``jax.jit`` on the CPU (no Pallas lies on this path).

Tolerances (float32 unless said):

* attention gradients: each of dq / dk / dv within 1e-5 of its largest
  entry (≈ 5e-7 measured: the same arithmetic summed in another order);
* losses within 1e-5 relative, every gradient leaf within 1e-4 of its
  largest |g| (≤ 6e-6 measured, recurrentgemma's scan the worst);
  ``lsh_a``, which the training forward never reads, gets a zero
  gradient, as JAX's;
* the one bfloat16 case (yi-6b's smoke config in its own dtype): loss
  within 1e-3 relative, each leaf's relative L2 error ≤ 0.05 and its
  largest error ≤ 0.05 of its largest |g| (≈ 7e-5 and 0.015 / 0.018
  measured: the frameworks round bfloat16 at other places);
* the remat modes: identical numbers (the recompute repeats the same
  operations);
* AdamW fed the same gradients: parameters and moments within 1e-6 of
  their leaf's largest entry (≤ 1.6e-7 measured: the global norms,
  summed over other leaf groupings, differ by an ulp in float32 and
  1.3e-6 over bfloat16 gradients — held to 1e-5 —, and an update that
  cancels a parameter to near 0 keeps that absolute error), bfloat16
  parameters within one bfloat16 rounding more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.models import flash_attention as jflash
from repro.models import layers as jL
from repro.models import model_module as jax_model_module
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import make_host_mesh
from repro_torch.models import flash_attention as tflash
from repro_torch.models import layers as tL
from repro_torch.models import model_module as tt_module
from repro_torch.models import transformer as tt
from repro_torch.train import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    loss_and_grads,
    lr_schedule,
    make_train_step,
)

LM_ARCHS = ["yi_6b", "deepseek_67b", "mistral_large_123b", "minitron_8b",
            "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "llama32_vision_11b",
            "recurrentgemma_9b", "xlstm_125m", "whisper_base"]
B, S = 2, 32


def _qkv(seed, Sq, Sk, H, KV, hd=16):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = r.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = r.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    do = r.normal(size=(B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _torch_vjp(fn, q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _close_to_largest(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,chunk,H,KV", [
    (True, 0, 16, 4, 2),    # causal, GQA, four chunks
    (True, 24, 16, 4, 1),   # windowed, one KV head
    (False, 0, 32, 4, 4),   # bidirectional, MHA, two chunks
    (True, 0, 1024, 8, 2),  # one chunk (chunk > Sk)
])
def test_flash_attention_grads_match_jax_vjp(causal, window, chunk, H, KV):
    q, k, v, do = _qkv(chunk + H, 64, 64, H, KV)
    want_out, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(a, b, c, causal, window,
                                                                   chunk), q, k, v)
    got_out, got = _torch_vjp(lambda a, b, c: tflash.flash_attention(a, b, c, causal, window,
                                                                     chunk), q, k, v, do)
    np.testing.assert_allclose(got_out, np.asarray(want_out), rtol=1e-6, atol=1e-6)
    _close_to_largest(got, vjp(do), 1e-5)


def test_flash_attention_forward_is_the_forward_bit_for_bit():
    """The autograd Function's output is ``_forward``'s, with or without
    a gradient recorded."""
    q, k, v, _ = _qkv(1, 64, 64, 4, 2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, _, _ = tflash._forward(tq, tk, tv, True, 0, 16)
    plain = out.reshape(B, 64, 4, 16)
    with torch.no_grad():
        assert torch.equal(tflash.flash_attention(tq, tk, tv, True, 0, 16), plain)
    graded = tflash.flash_attention(tq.requires_grad_(), tk, tv, True, 0, 16)
    assert graded.requires_grad and torch.equal(graded.detach(), plain)
    with pytest.raises(ValueError, match="chunk"):
        tflash.flash_attention(tq, tk[:, :40], tv[:, :40], True, 0, 16)


@pytest.mark.parametrize("causal,window,chunk,Sk,q_offset", [
    (True, 0, 24, 64, 0),     # 64 keys in chunks of 24: the padded last chunk
    (False, 0, 1024, 40, 0),  # cross attention's shape: one chunk of all keys
    (True, 16, 16, 64, 0),    # windowed
    (True, 0, 16, 80, 16),    # queries at an offset into longer keys
])
def test_chunked_attention_grads_match_jax(causal, window, chunk, Sk, q_offset):
    Sq = 64
    q, k, v, do = _qkv(Sk + chunk, Sq, Sk, 4, 2)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)
    want_out, vjp = jax.vjp(lambda a, b, c: jL.chunked_attention(a, b, c, **kw), q, k, v)
    got_out, got = _torch_vjp(lambda a, b, c: tL.chunked_attention(a, b, c, **kw), q, k, v, do)
    np.testing.assert_allclose(got_out, np.asarray(want_out), rtol=1e-6, atol=1e-6)
    _close_to_largest(got, vjp(do), 1e-5)
    # the differentiable route computes the serving route's numbers
    with torch.no_grad():
        plain = tL.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert np.array_equal(plain.numpy(), got_out)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _ce_inputs(seed, S_, d=32, V=96):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, S_, d)).astype(np.float32)
    head = (r.normal(size=(d, V)) * 0.2).astype(np.float32)
    labels = r.integers(0, V, (B, S_)).astype(np.int32)
    return x, head, labels


def test_cross_entropy_matches_jax():
    r = np.random.default_rng(5)
    logits = (r.normal(size=(B, 24, 96)) * 3).astype(np.float32)
    labels = r.integers(0, 96, (B, 24)).astype(np.int32)
    want, jg = jax.value_and_grad(lambda z: jt.cross_entropy(z, labels, 96))(logits)
    t = torch.from_numpy(logits).requires_grad_()
    got = tt.cross_entropy(t, torch.from_numpy(labels), 96)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    _close_to_largest([t.grad.numpy()], [jg], 1e-5)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (64, 512), (40, 16)])
def test_chunked_cross_entropy_matches_jax(S_, chunk):
    """Slabs when S is a multiple of the chunk (or the chunk covers S),
    the full-logits fallback when it is not (40 % 16)."""
    x, head, labels = _ce_inputs(S_ + chunk, S_)
    want, jg = jax.value_and_grad(lambda a, h: jt.chunked_cross_entropy(a, h, labels, chunk),
                                  argnums=(0, 1))(x, head)
    tx, th = torch.from_numpy(x).requires_grad_(), torch.from_numpy(head).requires_grad_()
    got = tt.chunked_cross_entropy(tx, th, torch.from_numpy(labels), chunk)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    _close_to_largest([tx.grad.numpy(), th.grad.numpy()], jg, 1e-5)


# fault C1: labels and tokens outside the padded vocabulary (losses to the
# reference's 1e-6 relative, gradients to 1e-5 of the largest; embedding
# rows equal, NaN included; logits NaN where the reference's are, the rest
# to 1e-4 of the largest)

VP_C1 = 16


@pytest.mark.parametrize("label", [-1, VP_C1, -VP_C1 - 1])
def test_cross_entropy_on_a_label_outside_the_vocabulary_matches_jax(label):
    """``jax.nn.one_hot`` gives a zero row there: the token adds its lse alone."""
    r = np.random.default_rng(11)
    logits = (r.normal(size=(2, 8, VP_C1)) * 2).astype(np.float32)
    labels = r.integers(0, VP_C1, (2, 8)).astype(np.int32)
    labels[1, 3] = label
    want, jg = jax.value_and_grad(lambda z: jt.cross_entropy(z, labels, VP_C1))(logits)
    t = torch.from_numpy(logits).requires_grad_()
    got = tt.cross_entropy(t, torch.from_numpy(labels), VP_C1)
    got.backward()
    assert np.isfinite(float(want))
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    _close_to_largest([t.grad.numpy()], [jg], 1e-5)


@pytest.mark.parametrize("label", [-1, VP_C1, -VP_C1 - 1])
def test_chunked_cross_entropy_on_a_label_outside_the_vocabulary_matches_jax(label):
    r = np.random.default_rng(12)
    x = r.normal(size=(2, 8, 4)).astype(np.float32)
    head = r.normal(size=(4, VP_C1)).astype(np.float32)
    labels = r.integers(0, VP_C1, (2, 8)).astype(np.int32)
    labels[0, 5] = label
    want = jt.chunked_cross_entropy(x, head, labels, 4)
    got = tt.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(head),
                                   torch.from_numpy(labels), 4)
    assert np.isfinite(float(want))
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


def test_embedding_lookup_follows_jnp_take_fill_mode():
    """[−Vp, Vp) wraps (−1 reads the last row), anything else a NaN row."""
    table = np.random.default_rng(13).normal(size=(VP_C1, 3)).astype(np.float32)
    tokens = np.array([[-VP_C1 - 1, -VP_C1, -1, 0, VP_C1 - 1, VP_C1, VP_C1 + 7]], np.int32)
    want = np.asarray(jnp.take(table, tokens, axis=0))
    got = tL.embed_lookup(torch.from_numpy(table), torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where the reference has NaN
    assert np.isnan(got[0, [0, 5, 6]]).all() and np.isfinite(got[0, 1:5]).all()


@pytest.mark.parametrize("arch", ["yi_6b", "whisper_base"])
def test_forward_on_tokens_outside_the_vocabulary_matches_jax(arch):
    jc, tc, jp, tp = _both(arch, "float32")
    Vp = tc.padded_vocab()
    toks = np.random.default_rng(14).integers(0, tc.vocab_size, (3, 8)).astype(np.int32)
    toks[0, 2], toks[1, 5], toks[2, 1] = -1, Vp, Vp + 7
    jb, tb = _batches(jc)
    mem = {n: v for n, v in jb.items() if n in ("image_embeds", "audio_frames")}
    if jc.family == "encdec":
        frames = np.asarray(mem["audio_frames"])[:1].repeat(3, axis=0)
        want, _ = jax_model_module(jc).forward(jp, jnp.asarray(toks), jnp.asarray(frames), jc)
        got, _ = tt_module(tc).forward(tp, torch.from_numpy(toks), torch.from_numpy(frames), tc)
    else:
        want, _ = jt.forward(jp, jnp.asarray(toks), jc)
        got, _ = tt.forward(tp, torch.from_numpy(toks), tc)
    want, got = np.asarray(want), got.detach().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1:]).any() and np.isfinite(want[0]).all()  # −1 wraps, Vp is NaN
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4 * np.abs(want[fin]).max())


def test_whisper_decode_step_reads_tokens_as_jnp_take_does():
    _, tc, _, tp = _both("whisper_base", "float32")
    Vp = tc.padded_vocab()
    mod = tt_module(tc)
    frames = torch.from_numpy(np.random.default_rng(15).normal(
        size=(1, tc.n_audio_frames, tc.d_model)).astype(np.float32) * 0.1)
    logits = {}
    for tok in (-1, Vp - 1, Vp + 7):
        with torch.inference_mode():
            caches = mod.init_cache(tc, 1, 8, device="cpu")
            mod.forward(tp, torch.zeros((1, 4), dtype=torch.int32), frames, tc, caches=caches,
                        logits_slice="last")
            logits[tok], _ = mod.decode_step(tp, caches, {"tokens": torch.full((1, 1), tok),
                                                          "position": 4}, tc)
    assert torch.equal(logits[-1], logits[Vp - 1]) and torch.isfinite(logits[-1]).all()
    assert torch.isnan(logits[Vp + 7]).all()


# ---------------------------------------------------------------------------
# the models' losses and gradients
# ---------------------------------------------------------------------------


def _batches(jc, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    if jc.family in ("vlm", "encdec"):
        name, M = (("image_embeds", jc.n_image_tokens) if jc.family == "vlm"
                   else ("audio_frames", jc.n_audio_frames))
        mem = (r.normal(size=(B, M, jc.d_model)) * 0.1).astype(np.float32)
        jb[name] = jnp.asarray(mem, jc.dtype)
        tb[name] = torch.from_numpy(mem).to(torch.float32 if jc.dtype == jnp.float32
                                            else torch.bfloat16)
    return jb, tb


def _both(arch, dtype):
    jc = jax_smoke_config(arch)
    tc = get_smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.replace(dtype=jnp.float32), tc.replace(dtype=torch.float32)
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _grads_against_jax(arch, dtype):
    jc, tc, jp, tp = _both(arch, dtype)
    jb, tb = _batches(jc)
    mod = jax_model_module(jc)
    want, jg = jax.jit(jax.value_and_grad(lambda p: mod.loss_fn(p, jb, jc)))(jp)
    got, tg = loss_and_grads(tp, tb, cfg=tc)
    named = dict(tp.named_parameters())
    unused = sorted(n for n, g in tg.items() if g is None)
    full = {n: torch.zeros_like(named[n]) if g is None else g for n, g in tg.items()}
    got_tree = lm_params_to_numpy(tc, full)
    assert jax.tree.structure(got_tree) == jax.tree.structure(jg)
    pairs = [(jax.tree_util.keystr(path), g, np.asarray(w, np.float32)) for (path, g), w
             in zip(jax.tree_util.tree_leaves_with_path(got_tree), jax.tree.leaves(jg))]
    return float(got), float(want), pairs, unused


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    got, want, pairs, unused = _grads_against_jax(arch, "float32")
    assert abs(got - want) <= 1e-5 * abs(want)
    for path, g, w in pairs:
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), f"{arch} {path}: {err} of {np.abs(w).max()}"
        if path.endswith("['lsh_a']"):  # never read by the training forward
            assert not w.any() and not g.any()
    cfg = get_smoke_config(arch)
    assert unused == sorted(f"blocks.{i}.attn.lsh_a" for i in range(cfg.n_layers)
                            if cfg.lsh_attention)


def test_bfloat16_loss_and_gradients_near_jax():
    got, want, pairs, _ = _grads_against_jax("yi_6b", "bfloat16")
    assert abs(got - want) <= 1e-3 * abs(want)
    for path, g, w in pairs:
        if not w.any():
            assert not g.any(), path
            continue
        assert np.linalg.norm(g - w) <= 0.05 * np.linalg.norm(w), path
        assert np.abs(g - w).max() <= 0.05 * np.abs(w).max(), path


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "recurrentgemma_9b", "whisper_base"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """Attention and MoE units (dense layers are their attention half),
    the hybrid's (rec, rec, local) unit and its remainder, whisper's
    per-layer decoder remat."""
    _, tc, _, tp = _both(arch, "float32")
    _, tb = _batches(jax_smoke_config(arch).replace(dtype=jnp.float32))
    runs = {r: loss_and_grads(tp, tb, cfg=tc, remat=r) for r in ("unit", "dots", "none")}
    loss, grads = runs["unit"]
    for r in ("dots", "none"):
        assert torch.equal(runs[r][0], loss)
        for n, g in grads.items():
            assert (g is None and runs[r][1][n] is None) or torch.equal(runs[r][1][n], g), n
    with pytest.raises(ValueError, match="remat"):
        tt.forward(tp, tb["tokens"], tc, remat="all") if tc.family != "encdec" else (
            tL.remat_call(lambda x: x, tb["tokens"], remat="all"))


def test_serving_under_inference_mode_after_training():
    """Trained parameters (requires_grad) serve under the steps'
    inference mode and give the frozen forward's logits."""
    _, tc, _, tp = _both("yi_6b", "float32")
    _, tb = _batches(jax_smoke_config("yi_6b").replace(dtype=jnp.float32))
    with torch.no_grad():
        frozen, _ = tt.forward(tp, tb["tokens"], tc)
    loss_and_grads(tp, tb, cfg=tc)
    assert all(p.requires_grad for p in tp.parameters())
    with torch.inference_mode():
        served, _ = tt.forward(tp, tb["tokens"], tc)
    assert torch.equal(served, frozen)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_draw_each_leaf_like_the_reference(arch):
    """The port's own seeded parameters, which the card trains from,
    against the reference's: the draws differ, their laws must not.  A
    constant leaf (norm scales, zero biases) equals the reference's; a
    drawn leaf of n entries has its std within 6 standard errors of the
    difference of two std estimates (std / √n) of the reference's, and
    its mean within 6 of the difference of two means (std · √(2 / n))
    (≤ 3.6 and ≤ 2.4 measured, recurrentgemma's heavy-tailed RG-LRU
    decay and whisper the worst)."""
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    want = jax.tree.leaves(jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0)))
    got = jax.tree.leaves(lm_params_to_numpy(tc, tt_module(tc).init_params(tc, 0, device="cpu")))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, i
        s = w.std()
        if s == 0:
            assert np.array_equal(g, w), f"{arch} leaf {i} {w.shape}"
            continue
        assert abs(g.std() - s) <= 6 * s / np.sqrt(w.size), f"{arch} leaf {i} {w.shape}"
        assert abs(g.mean() - w.mean()) <= 6 * s * np.sqrt(2 / w.size), \
            f"{arch} leaf {i} {w.shape}"


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference_on_the_same_gradients(dtype):
    """Three steps fed the same numpy gradients (clipped: their norm is
    past grad_clip), one leaf with none (lsh_a) — the reference's zeros."""
    jc, tc, jp, tp = _both("yi_6b", dtype)
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1)
    r = np.random.default_rng(11)
    jstate = jopt.init_opt_state(jp)
    tstate = init_opt_state(tp)
    jupdate = jax.jit(lambda p, g, o: jopt.adamw_update(ocfg, p, g, o))
    names = [n for n, _ in tp.named_parameters()]
    for _ in range(3):
        grads = {n: None if n.endswith("lsh_a") else
                 (r.normal(size=tuple(p.shape)) * 0.3).astype(np.float32)
                 for n, p in tp.named_parameters()}
        tgrads = {n: None if g is None else torch.from_numpy(g).to(tp.get_parameter(n).dtype)
                  for n, g in grads.items()}
        full = {n: tgrads[n] if tgrads[n] is not None else torch.zeros_like(tp.get_parameter(n))
                for n in names}
        jgrads = jax.tree.map(lambda a: jnp.asarray(a), lm_params_to_numpy(tc, full))
        if dtype == "bfloat16":
            jgrads = jax.tree.map(lambda g, p: g.astype(p.dtype), jgrads, jp)
        jp, jstate, jm = jupdate(jp, jgrads, jstate)
        tp, tstate, tm = adamw_update(ocfg, tp, tgrads, tstate)
        assert float(tm["grad_norm"]) > ocfg.grad_clip
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0  # a bfloat16 rounding either way
    got_p, got_o = lm_params_to_numpy(tc, tp), opt_state_to_numpy(tc, tstate)
    for got, want in ((got_p, jp), (got_o["mu"], jstate["mu"]), (got_o["nu"], jstate["nu"])):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            w = np.asarray(w, np.float32)
            assert np.all(np.abs(g - w) <= ulp * np.abs(w) + 1e-6 * np.abs(w).max())


def test_lr_schedule_and_global_norm_match_the_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        got = float(lr_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.lr_schedule(jcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    r = np.random.default_rng(2)
    leaves = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    got = float(global_norm([torch.from_numpy(a) for a in leaves] + [None]))
    assert got == pytest.approx(float(jopt.global_norm(leaves)), rel=1e-6)


def test_opt_state_round_trips_through_the_reference_tree():
    _, tc, _, tp = _both("recurrentgemma_9b", "bfloat16")
    state = init_opt_state(tp)
    for t in state["mu"].values():
        t.normal_()
    state["step"] = torch.tensor(7, dtype=torch.int32)
    back = opt_state_from_numpy(tc, opt_state_to_numpy(tc, state), device="cpu")
    assert int(back["step"]) == 7 and back["step"].dtype == torch.int32
    assert all(torch.equal(back["mu"][n], t) and back["nu"][n].dtype == torch.float32
               for n, t in state["mu"].items())
    with pytest.raises(ValueError, match="layout"):
        opt_state_from_numpy(get_smoke_config("yi_6b"), opt_state_to_numpy(tc, state),
                             device="cpu")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_make_train_step_updates_in_place_and_refuses_the_multi_card_options():
    tc = get_smoke_config("yi_6b").replace(dtype=torch.float32)
    specs = {"tokens": torch.empty((B, S), device="meta"),
             "labels": torch.empty((B, S), device="meta")}
    mesh = make_host_mesh(device="cpu")
    fn, info = make_train_step(tc, mesh, batch_specs=specs, sequence_parallel=True)
    assert info["batch"] == {"tokens": (B, S), "labels": (B, S)}
    assert set(info["abstract_opt"]) == {"mu", "nu", "step"}
    assert info["abstract_opt"]["step"].device.type == "meta"
    params = tt.init_params(tc, 0, device="cpu")
    opt = init_opt_state(params)
    before = params.embed.detach().clone()
    batch = tpipe.SyntheticTokens(tc.vocab_size, B, S, seed=0).batch_at(0)
    p2, o2, metrics = fn(params, opt, batch)  # numpy batches go to the mesh's device
    assert p2 is params and o2 is opt and int(opt["step"]) == 1
    assert not torch.equal(params.embed, before)
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    with pytest.raises(ValueError, match="batch"):
        fn(params, opt, tpipe.SyntheticTokens(tc.vocab_size, B, S + 1).batch_at(0))
    _, finfo = make_train_step(tc, mesh, fsdp=True)  # FSDP runs now (ROADMAP A12d3)
    assert finfo["parallel"] and set(finfo["opt_pspecs"]) == {"mu", "nu", "step"}


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed", [(100, 4, 8, 3), (64000, 1, 4096, 0),
                                                  (512, 2, 16, 7)])
def test_synthetic_tokens_equal_the_reference(vocab, batch, seq, seed):
    want = jpipe.SyntheticTokens(vocab, batch, seq, seed=seed)
    got = tpipe.SyntheticTokens(vocab, batch, seq, seed=seed)
    for step in (0, 1, 17):
        a, b = got.batch_at(step), want.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = iter(got)
    assert np.array_equal(next(it)["tokens"], want.batch_at(0)["tokens"])


def test_prefetcher_order_and_close():
    src = tpipe.SyntheticTokens(100, 2, 8, seed=1)
    pf = tpipe.Prefetcher(src, start_step=5, depth=2)
    try:
        for step in range(5, 9):
            got_step, b = pf.get()
            assert got_step == step
            assert np.array_equal(b["tokens"], src.batch_at(step)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
