"""The hybrid, ssm and encdec families' blocks of the port
(``repro_torch.models.{scan,recurrent,xlstm,whisper}``) held against
``repro.models.{recurrent,xlstm,whisper}`` and ``jax.lax.associative_scan``
on the same numpy inputs, at float32, with the JAX parameters carried
across.

Tolerances:

* the scan: bit for bit in ``h`` (the same odd/even recursion makes the
  same float associations); the running product of ``a`` to 1e-30
  absolute, since the two frameworks may flush a subnormal product to 0
  differently;
* block outputs and states: 1e-5 of the largest entry of the
  reference's, through 3–4 matmuls, a scan and the frameworks' own
  transcendental functions (≤ 7e-7 measured);
* whisper's logits: 1e-4 of the largest logit, its caches 1e-5 of their
  largest entry, as the decoder LM's in ``test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import recurrent as jrec
from repro.models import whisper as jw
from repro.models import xlstm as jx
from repro_torch.configs import base as tcb
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import recurrent as trec
from repro_torch.models import whisper as tw
from repro_torch.models import xlstm as tx
from repro_torch.models.scan import linear_scan

CPU = torch.device("cpu")
OUT_TOL, LOGIT_TOL = 1e-5, 1e-4


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), CPU)


def _close(got, want, tol=OUT_TOL, what=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _configs(arch):
    return (jcb.get_smoke_config(arch).replace(dtype=jnp.float32),
            tcb.get_smoke_config(arch).replace(dtype=torch.float32))


def _carry(tree) -> dict:
    return {n: _t(a) for n, a in jax.tree.map(np.asarray, tree).items()}


# ---------------------------------------------------------------------------
# the scan helper
# ---------------------------------------------------------------------------


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a2 * a1, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 7, 64, 300])
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, size=(2, S, 5)).astype(np.float32)
    b = rng.normal(size=(2, S, 5)).astype(np.float32)
    want_a, want_h = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got_a, got_h = linear_scan(_t(a), _t(b), dim=1)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6, atol=1e-30)
    # the recurrence it computes, step by step
    h, serial = np.zeros((2, 5), np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        serial.append(h)
    np.testing.assert_allclose(got_h.numpy(), np.stack(serial, 1), rtol=1e-4, atol=1e-4)
    # along another axis, the same numbers
    got_t = linear_scan(_t(a).transpose(0, 1), _t(b).transpose(0, 1), dim=0)[1]
    assert torch.equal(got_t.transpose(0, 1), got_h)
    with pytest.raises(ValueError, match="differ"):
        linear_scan(_t(a), _t(b[..., :1]))


# ---------------------------------------------------------------------------
# RG-LRU, mLSTM, sLSTM
# ---------------------------------------------------------------------------


def _state(rng, specs, scale=0.5):
    """Random carried states of the reference's spec shapes: (jax, port)."""
    arrays = {n: (rng.normal(size=s.shape) * scale).astype(np.float32) for n, s in specs.items()}
    return ({n: jnp.asarray(a) for n, a in arrays.items()},
            {n: torch.tensor(a) for n, a in arrays.items()})


def _run_block(jfn, tfn, jp, tp, x, jc, tc, specs, carried, **kw):
    rng = np.random.default_rng(x.shape[1] + 100)
    jstate = tstate = None
    if carried:
        jstate, tstate = _state(rng, specs)
    want, wstate = jfn(jp, jnp.asarray(x), jc, state=jstate, **kw)
    got, gstate = tfn(tp, _t(x), tc, state=tstate, **kw)
    _close(got, want, what="output")
    if carried:
        assert gstate is tstate  # written in place
    if wstate is None:
        assert gstate is None
        return
    assert set(gstate) == set(wstate)
    for n in wstate:
        assert gstate[n].dtype == torch.float32 or n == "conv"
        _close(gstate[n], wstate[n], what=f"state {n}")


@pytest.mark.parametrize("S", [1, 13])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_matches_jax(S, carried):
    jc, tc = _configs("recurrentgemma_9b")
    jp = jrec.init_rglru_block(jax.random.PRNGKey(1), jc)
    x = np.random.default_rng(S).normal(size=(2, S, jc.d_model)).astype(np.float32)
    _run_block(jrec.rglru_block_apply, trec.rglru_block_apply, jp, _carry(jp), x, jc, tc,
               jrec.rglru_state_specs(jc, 2), carried)


def test_rglru_pieces_match_jax():
    """The conv's left-to-right sum with its tail, the block-diagonal gate,
    softplus as logaddexp and the layout of the drawn parameters."""
    jc, tc = _configs("recurrentgemma_9b")
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = rng.normal(size=(4, 64)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 64)).astype(np.float32)
    for tl in (None, tail):
        want, wtail = jrec._causal_conv1d(jnp.asarray(u), jnp.asarray(w),
                                          None if tl is None else jnp.asarray(tl))
        got, gtail = trec._causal_conv1d(_t(u), _t(w), None if tl is None else _t(tl))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gtail.numpy(), np.asarray(wtail))
    bd = rng.normal(size=(4, 16, 16)).astype(np.float32)
    _close(trec._block_diag_apply(_t(u), _t(bd)), jrec._block_diag_apply(jnp.asarray(u),
                                                                         jnp.asarray(bd)))
    z = np.linspace(-30, 30, 121, dtype=np.float32)
    _close(trec.softplus(_t(z)), jax.nn.softplus(jnp.asarray(z)), 1e-7)
    jp = jrec.init_rglru_block(jax.random.PRNGKey(0), jc)
    own = trec.init_rglru_block(torch.Generator().manual_seed(0), tc, device=CPU)
    assert {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()} == {
        n: (tuple(a.shape), torch.float32) for n, a in jp.items()}
    a = torch.exp(-trec._C * trec.softplus(own["lam"]) * 0.5)  # a at σ(r) = 1/2
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


MLSTM_CASES = {
    # name: (S, carried)
    "decode": (1, False),
    "decode_carried": (1, True),
    "short": (40, False),  # one chunk of 40
    "short_carried": (40, True),
    "two_chunks": (128, False),
    "two_chunks_carried": (128, True),
}


@pytest.mark.parametrize("name", sorted(MLSTM_CASES))
def test_mlstm_block_matches_jax(name):
    S, carried = MLSTM_CASES[name]
    jc, tc = _configs("xlstm_125m")
    jp = jx.init_mlstm_block(jax.random.PRNGKey(2), jc)
    x = np.random.default_rng(S).normal(size=(2, S, jc.d_model)).astype(np.float32)
    _run_block(jx.mlstm_block_apply, tx.mlstm_block_apply, jp, _carry(jp), x, jc, tc,
               jx.xlstm_state_specs(jc, 2, "mlstm"), carried)


def test_mlstm_refuses_a_sequence_off_the_chunk_like_the_reference():
    """S = 96 with chunks of 64: the reference asserts, the port raises."""
    jc, tc = _configs("xlstm_125m")
    jp = jx.init_mlstm_block(jax.random.PRNGKey(2), jc)
    x = np.zeros((1, 96, jc.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jx.mlstm_block_apply(jp, jnp.asarray(x), jc)
    with pytest.raises(ValueError, match="not divisible"):
        tx.mlstm_block_apply(_carry(jp), _t(x), tc)
    # a chunk of its own length is fine for both
    want, _ = jx.mlstm_block_apply(jp, jnp.asarray(x), jc, chunk=96)
    got, _ = tx.mlstm_block_apply(_carry(jp), _t(x), tc, chunk=96)
    _close(got, want)


@pytest.mark.parametrize("S", [1, 13])
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_block_matches_jax(S, carried):
    jc, tc = _configs("xlstm_125m")
    jp = jx.init_slstm_block(jax.random.PRNGKey(3), jc)
    x = np.random.default_rng(S + 7).normal(size=(2, S, jc.d_model)).astype(np.float32)
    _run_block(jx.slstm_block_apply, tx.slstm_block_apply, jp, _carry(jp), x, jc, tc,
               jx.xlstm_state_specs(jc, 2, "slstm"), carried)


def test_xlstm_gates_are_float32_and_layouts_match_jax():
    jc, tc = tcb.get_smoke_config("xlstm_125m"), tcb.get_smoke_config("xlstm_125m")
    jcj = jcb.get_smoke_config("xlstm_125m")
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit in ((jx.init_mlstm_block, tx.init_mlstm_block),
                         (jx.init_slstm_block, tx.init_slstm_block)):
        jp = jinit(jax.random.PRNGKey(0), jcj)
        tp = tinit(gen, tc, device=CPU)
        got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1]) for n, p in tp.named_parameters()}
        assert got == {n: (tuple(a.shape), str(a.dtype)) for n, a in jp.items()}
        assert got["w_f"][1] == "float32" and got["w_i"][1] == "float32"
    for kind in ("mlstm", "slstm"):
        want = jx.xlstm_state_specs(jcj, 3, kind)
        got = tx.xlstm_state_specs(tc, 3, kind)
        assert {n: (tuple(t.shape), t.dtype, t.device.type) for n, t in got.items()} == {
            n: (tuple(s.shape), torch.float32, "meta") for n, s in want.items()}


# ---------------------------------------------------------------------------
# whisper's encoder-decoder
# ---------------------------------------------------------------------------

_WHISPER = {}


def _whisper(frames=None):
    """(jax cfg, port cfg, jax params, port params) of the smoke config,
    with ``n_audio_frames`` replaced where given."""
    if frames not in _WHISPER:
        jc, tc = _configs("whisper_base")
        if frames is not None:
            jc, tc = jc.replace(n_audio_frames=frames), tc.replace(n_audio_frames=frames)
        jp = jw.init_params(jc, jax.random.PRNGKey(0))
        _WHISPER[frames] = (jc, tc, jp,
                            lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu"))
    return _WHISPER[frames]


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("frames", [None, 1040])  # 32: the flash route; 1,040: chunked
def test_whisper_encode_matches_jax(frames):
    jc, tc, jp, tp = _whisper(frames)
    fr = _frames(jc, 2, 1)
    _close(tw.encode(tp, _t(fr), tc), jw.encode(jp, jnp.asarray(fr), jc))


@pytest.mark.parametrize("logits_slice", ["all", "last"])
def test_whisper_forward_matches_jax(logits_slice):
    jc, tc, jp, tp = _whisper()
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    fr = _frames(jc, 2, 6)
    want, _ = jw.forward(jp, jnp.asarray(tok), jnp.asarray(fr), jc, logits_slice=logits_slice)
    got, caches = tw.forward(tp, _t(tok), _t(fr), tc, logits_slice=logits_slice)
    assert caches is None and got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    with pytest.raises(ValueError, match="logits_slice"):
        tw.forward(tp, _t(tok), _t(fr), tc, logits_slice="hidden")


def _whisper_layers(jcache, part):
    names = ("k", "v") if part == "self" else ("ck", "cv")
    n_layers = np.asarray(jcache[part][names[0]]).shape[0]
    return [{n: np.asarray(jcache[part][n][i]) for n in names} for i in range(n_layers)]


def test_whisper_prefill_and_decode_steps_match_jax():
    """Prefill 16 tokens into 24-row caches (self K/V and the cross K/V of
    the encoded frames), then 4 decode steps reading both caches."""
    jc, tc, jp, tp = _whisper()
    B, S, Smax = 2, 16, 24
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    fr = _frames(jc, B, 8)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jw.cache_specs(jc, B, Smax))
    tcache = tw.init_cache(tc, B, Smax, device="cpu")
    assert {p: [{n: tuple(t.shape) for n, t in c.items()} for c in layers]
            for p, layers in tcache.items()} == {
        p: [{n: a.shape for n, a in c.items()} for c in _whisper_layers(jcache, p)]
        for p in ("self", "cross")}
    want, jcache = jw.forward(jp, jnp.asarray(tok), jnp.asarray(fr), jc, caches=jcache,
                              logits_slice="last")
    got, tcache2 = tw.forward(tp, _t(tok), _t(fr), tc, caches=tcache, logits_slice="last")
    assert tcache2 is tcache
    for step in range(5):
        _close(got, want, LOGIT_TOL, f"step {step} logits")
        for part in ("self", "cross"):
            for layer, (g, w) in enumerate(zip(tcache[part], _whisper_layers(jcache, part))):
                for n in w:
                    _close(g[n], w[n], what=f"step {step} {part} layer {layer} {n}")
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        assert np.array_equal(got.argmax(-1).numpy(), nxt)
        want, jcache = jw.decode_step(jp, jcache, {"tokens": jnp.asarray(nxt),
                                                   "position": jnp.int32(S + step)}, jc)
        got, _ = tw.decode_step(tp, tcache, {"tokens": _t(nxt),
                                             "position": torch.tensor(S + step)}, tc)


def test_whisper_layout_and_converter_checks():
    jc, tc, jp, tp = _whisper()
    tree = jax.tree.map(np.asarray, jp)
    assert sum(p.numel() for p in tp.parameters()) == sum(x.size for x in jax.tree.leaves(jp))
    assert len(tp.encoder) == tc.encoder_layers and len(tp.decoder) == tc.n_layers
    # layer 1 of the decoder is the reference's stacked slice 1
    np.testing.assert_array_equal(tp.decoder[1]["xattn"]["wk"].numpy(),
                                  tree["decoder"]["xattn"]["wk"][1])
    own = tw.init_params(tc, 0, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in tw.abstract_params(tc).named_parameters()]
    assert all(p.device.type == "meta" for p in tw.abstract_params(tc).parameters())
    with pytest.raises(ValueError, match="stacked"):
        lm_params_from_numpy(tc.replace(n_layers=3), tree, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(tc.replace(d_ff=96), tree, device="cpu")
    with pytest.raises(ValueError, match="caches"):
        cache = tw.init_cache(tc, 1, 4, device="cpu")
        cache["cross"] = cache["cross"][:1]
        tw.forward(tp, torch.zeros((1, 4), dtype=torch.int32),
                   torch.zeros((1, tc.n_audio_frames, tc.d_model)), tc, caches=cache)
