"""The port's LM serving path (``repro_torch.serve.serve_step``'s
``make_prefill`` / ``make_decode_step``, ``repro_torch.launch.serve``)
held against the reference's on the same parameters and prompts.

The reference's ``serve_batch`` draws its parameters from
``jax.random.PRNGKey(seed)``; the port's takes those parameters,
carried across by ``convert.lm_params_from_numpy``, and its prompts are
the reference's (``numpy.random.default_rng(seed)``).  At float32 the
greedy tokens must be identical — 8 of them per request, decoded past
the smoke configs' T = 32, so PM-LSH selection runs at every step where
a config has it, and the recurrent states and whisper's cross K/V carry
through every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import model_module as jax_model_module
from repro.models import transformer as jt
from repro.serve.serve_step import make_decode_step as jax_make_decode_step
from repro.serve.serve_step import make_prefill as jax_make_prefill
from repro_torch import serve as tserve
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.launch import make_host_mesh
from repro_torch.launch import serve as tlaunch
from repro_torch.models import whisper as tw
from repro_torch.serve.serve_step import make_decode_step, make_prefill

# every family: dense, moe, vlm, hybrid, ssm and encdec
LM_ARCHS = ["yi_6b", "deepseek_67b", "mistral_large_123b", "minitron_8b",
            "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b", "llama32_vision_11b",
            "recurrentgemma_9b", "xlstm_125m", "whisper_base"]


def _mesh():
    return make_host_mesh(device="cpu")


def _f32(arch):
    return (jax_smoke_config(arch).replace(dtype=jnp.float32),
            get_smoke_config(arch).replace(dtype=torch.float32))


def _carried(jc, tc, seed=0):
    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(seed))
    return lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_batch_greedy_tokens_match_the_reference(arch):
    jc, tc = _f32(arch)
    want = jax_serve_batch(jc, jax_host_mesh(), batch=2, prompt_len=32, gen=8, seed=0)
    got = tlaunch.serve_batch(tc, _mesh(), batch=2, prompt_len=32, gen=8, seed=0,
                              params=_carried(jc, tc))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (2, 8)
    assert got["logits"].shape == (2, 8, tc.padded_vocab())
    assert np.array_equal(got["logits"].argmax(-1).numpy(), got["tokens"])
    assert got["prefill_s"] > 0 and got["decode_s_per_token"] > 0


@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_moe_a2_7b", "llama32_vision_11b",
                                  "recurrentgemma_9b", "xlstm_125m", "whisper_base"])
def test_model_steps_match_the_reference_steps(arch):
    """The steps themselves, driven by hand as serve_batch drives them:
    logits of the prefill and of each decode step to 1e-4 of the largest
    logit, the info dicts' keys and shapes the reference's."""
    jc, tc = _f32(arch)
    B, S, Smax = 2, 32, 40
    jmesh = jax_host_mesh()
    with jmesh:
        jpre, jinfo = jax_make_prefill(jc, jmesh, batch=B, seq_len=S, max_seq=Smax)
        jdec, _ = jax_make_decode_step(jc, jmesh, batch=B, max_seq=Smax)
    tpre, tinfo = make_prefill(tc, _mesh(), batch=B, seq_len=S, max_seq=Smax)
    tdec, dinfo = make_decode_step(tc, _mesh(), batch=B, max_seq=Smax)
    # the reference's keys, and the decode's form (the one-device mesh: plain)
    assert set(tinfo) == set(dinfo) == set(jinfo) | {"lsh_shard"}
    assert tinfo["lsh_shard"] is dinfo["lsh_shard"] is None
    assert {n: tuple(s.shape) for n, s in jinfo["batch_specs"].items()} == tinfo["batch"]
    assert dinfo["batch"]["tokens"] == (B, 1) and dinfo["batch"]["position"] == ()
    kv = (B, Smax, tc.n_kv_heads, tc.head_dim)
    if tc.family == "encdec":
        assert len(tinfo["cache"]["self"]) == len(tinfo["cache"]["cross"]) == tc.n_layers
        assert tinfo["cache"]["self"][0]["k"] == kv
        assert tinfo["cache"]["cross"][0]["ck"] == (B, tc.n_audio_frames) + kv[2:]
        assert tinfo["batch"]["audio_frames"] == (B, tc.n_audio_frames, tc.d_model)
        assert isinstance(tinfo["abstract_params"], tw.EncDecLM)
    else:
        assert len(tinfo["cache"]) == tc.n_layers
        kinds = tinfo["abstract_params"].kinds
        for kind, cache in zip(kinds, tinfo["cache"]):  # the reference's spec a kind
            want = {"rec": {"h": (B, tc.rnn_width or tc.d_model),
                            "conv": (B, tc.conv1d_width - 1, tc.rnn_width or tc.d_model)},
                    "mlstm": {"C": (B, tc.n_heads) + (tc.d_model // tc.n_heads,) * 2,
                              "n": (B, tc.n_heads, tc.d_model // tc.n_heads)},
                    "slstm": {"c": (B, tc.d_model), "n": (B, tc.d_model)}}.get(kind)
            assert cache == want if want else cache["k"] == kv
    assert tinfo["params"]["embed"] == (tc.padded_vocab(), tc.d_model)

    jp = jax_model_module(jc).init_params(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if jc.family in ("vlm", "encdec"):
        name, M = (("image_embeds", jc.n_image_tokens) if jc.family == "vlm"
                   else ("audio_frames", jc.n_audio_frames))
        mem = (rng.normal(size=(B, M, jc.d_model)) * 0.1).astype(np.float32)
        jb[name], tb[name] = jnp.asarray(mem), torch.from_numpy(mem)
    want, jcache = jpre(jp, jb)
    got, tcache = tpre(tp, tb)
    for step in range(4):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
        nxt = w.argmax(-1).astype(np.int32)
        jb = {**jb, "tokens": jnp.asarray(nxt), "position": jnp.int32(S + step)}
        tb = {**tb, "tokens": torch.from_numpy(nxt), "position": S + step}
        want, jcache = jdec(jp, jcache, jb)
        got, tcache2 = tdec(tp, tcache, tb)
        assert tcache2 is tcache  # the decode step writes the cache in place
    with pytest.raises(ValueError, match="built for tokens"):
        tpre(tp, {"tokens": torch.zeros((B, S + 1), dtype=torch.int32)})


def test_serve_batch_is_deterministic_for_a_seed():
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    a = tlaunch.serve_batch(cfg, _mesh(), batch=2, prompt_len=16, gen=4, seed=5)
    b = tlaunch.serve_batch(cfg, _mesh(), batch=2, prompt_len=16, gen=4, seed=5)
    c = tlaunch.serve_batch(cfg, _mesh(), batch=2, prompt_len=16, gen=4, seed=6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["logits"].dtype == torch.float32 and bool(torch.isfinite(a["logits"]).all())


def test_main_prints_the_same_tokens_for_a_seed(capsys):
    argv = ["--arch", "yi-6b", "--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "4",
            "--device", "cpu"]
    tlaunch.main(argv)
    first = capsys.readouterr().out
    tlaunch.main(argv)
    second = capsys.readouterr().out
    assert "yi-smoke: prefill" in first and "(batch 2, cpu)" in first
    tokens = [line for line in first.splitlines() if line.startswith("first request tokens")]
    assert tokens and tokens == [line for line in second.splitlines()
                                 if line.startswith("first request tokens")]
    want = tlaunch.serve_batch(get_smoke_config("yi-6b"), _mesh(), batch=2, prompt_len=16,
                               gen=4, seed=0)["tokens"][0].tolist()
    assert tokens[0] == f"first request tokens: {want}"


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m", "whisper_base"])
def test_main_serves_the_recurrent_and_encdec_families(arch, capsys):
    """The CLI over the smoke configs of the families the reference's
    ``serve_batch`` serves beside the decoders: the tokens it prints are
    ``serve_batch``'s for the seed, each in the padded vocabulary (the
    reference's argmax runs over all of it)."""
    tlaunch.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "16",
                  "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = get_smoke_config(arch)
    assert f"{cfg.name}: prefill" in out and "(batch 2, cpu)" in out
    want = tlaunch.serve_batch(cfg, _mesh(), batch=2, prompt_len=16, gen=3, seed=0)
    assert f"first request tokens: {want['tokens'][0].tolist()}" in out
    assert want["tokens"].min() >= 0 and want["tokens"].max() < cfg.padded_vocab()


def test_host_mesh_is_one_device_and_model_parallel_raises_naming_a12d():
    mesh = _mesh()
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu")
    from repro_torch.launch import axis_size, dp_axes

    assert dp_axes(mesh) == ("data",) and axis_size(mesh, "model") == 1
    assert axis_size(mesh, "pod") == 1
    # the 'model' axis runs now (ROADMAP A12d3): an emulated (1, 2) mesh
    two = make_host_mesh(model=2, device="cpu")
    assert two.shape == {"data": 1, "model": 2} and axis_size(two, "model") == 2
    tlaunch.main(["--arch", "yi-6b", "--smoke", "--model-parallel", "2", "--device", "cpu",
                  "--gen", "2"])


def test_serve_package_exports_the_model_steps():
    """``repro_torch.serve.make_prefill`` no longer raises: it is the step."""
    assert tserve.make_prefill is make_prefill
    assert tserve.make_decode_step is make_decode_step
    fn, info = tserve.make_prefill(get_smoke_config("yi_6b"), _mesh(), batch=1, seq_len=8)
    assert callable(fn) and info["batch"]["tokens"] == (1, 8)
    with pytest.raises(AttributeError):
        tserve.make_train_step  # noqa: B018


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 0)])
def test_bf16_round_trip_is_bit_exact(shape):
    import ml_dtypes

    rng = np.random.default_rng(len(shape))
    bits = rng.integers(0, 2**16, size=shape, dtype=np.uint16)
    bits[..., :1] = np.uint16(0x7FC1)  # a NaN payload survives too
    a = bits.view(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)
    back = t.float().numpy()
    np.testing.assert_array_equal(back, a.astype(np.float32))


def test_converter_carries_bf16_params_bit_for_bit_and_checks_the_layout():
    jc, tc = jax_smoke_config("yi_6b"), get_smoke_config("yi_6b")  # bfloat16
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(1)))
    tp = lm_params_from_numpy(tc, jp, device="cpu")
    wq = jp["unit"][0]["attn"]["wq"][1]  # layer 1's, unstacked
    got = tp.blocks[1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), wq.view(np.int16))
    assert tp.blocks[0]["ln1"].dtype == torch.float32
    with pytest.raises(ValueError, match="layout"):
        lm_params_from_numpy(tc.replace(d_ff=96), jp, device="cpu")
    with pytest.raises(ValueError, match="unit"):
        lm_params_from_numpy(tc.replace(n_layers=3), jp, device="cpu")
