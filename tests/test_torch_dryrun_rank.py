"""The dry run's abstract rank (``launch.mesh.make_abstract_mesh``: one
rank of a ('data', 'model') group on the meta device, each collective
tallied): against the one-device step at (1, 1), against the blocks the
layouts give it, and one MoE layer's collective tally derived by hand;
the layouts behind it (a rank's blocks held alone, a batch-1 decode's
caches).  Its FLOPs summed over the ranks against the emulated mesh are
in ``test_torch_dryrun_sum.py``.
"""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr
from repro_torch.launch import make_host_mesh
from repro_torch.launch.mesh import CollectiveTally, make_abstract_mesh
from repro_torch.launch.sharding import batch_pspecs, cache_pspecs, layer_layouts, local_shape
from repro_torch.models import model_module, parallel
from repro_torch.serve.serve_step import lsh_shard_rule
from repro_torch.train.train_step import shard_params

ARCHS = [a.replace("_", "-") for a in list_archs()]
# a meta step's cost is its op count: short sequences keep the scans'
# steps few; a decode's 64 cache rows split over 4 sequence shards hold the
# smoke configs' local PM-LSH budget
KINDS = {"train": InputShape("train", 16, 4, "train"),
         "prefill": InputShape("prefill", 16, 4, "prefill"),
         "decode": InputShape("decode", 64, 4, "decode"),
         "decode_b1": InputShape("decode", 64, 1, "decode")}


def meta_mesh(D: int, M: int):
    return make_host_mesh(M, data=D, device="meta")


def flops_by_op(step, args) -> dict:
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ---------------------------------------------------------------------------
# the abstract rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_rank_at_one_chip_equals_the_one_device_step(arch, kind):
    """A group of one (the abstract rank at (1, 1), which runs the
    group's data-parallel program) does the one-device step's FLOPs, op
    for op, and moves nothing."""
    cfg = get_smoke_config(arch)
    tally = CollectiveTally()
    one = flops_by_op(*dr.cell_step(cfg, KINDS[kind], meta_mesh(1, 1))[:2])
    step, args, _ = dr.cell_step(cfg, KINDS[kind], make_abstract_mesh(1, 1, tally=tally))
    assert flops_by_op(step, args) == one
    assert not any(tally.bytes.values()) and not any(tally.counts.values())
    assert dr.rank_mesh(1, 1).emulated and not dr.rank_mesh(2, 1).emulated


def _expected_rank_bytes(cfg, shape, mesh, fsdp: bool) -> int:
    """Rank (0, 0)'s blocks from the layouts alone: each parameter's
    ``local_shape`` (none of a layer another shard owns), AdamW's two
    float32 moments beside it for training, the cache blocks of
    ``cache_pspecs`` (the sequence split only for the sharded decode) and
    the batch rows of ``batch_pspecs``; AdamW's int32 step."""
    layouts = layer_layouts(cfg, mesh, fsdp=fsdp)
    itemsize = {n: p.element_size() for n, p in
                model_module(cfg).abstract_params(cfg).named_parameters()}
    total = 4 if shape.kind == "train" else 0
    for name, lay in layouts.items():
        if lay.layer_axes is None or lay.owner == 0:
            moments = 8 if shape.kind == "train" else 0
            total += _numel(lay.local_shape(mesh)) * (itemsize[name] + moments)
    specs = tconfigs.input_specs(cfg, shape)
    for k, t in specs.items():
        total += _numel(local_shape(tuple(t.shape), batch_pspecs(specs, mesh)[k], mesh)) \
            * t.element_size()
    if shape.kind == "decode":
        c_specs = model_module(cfg).cache_specs(cfg, shape.global_batch, shape.seq_len)
        rule = lsh_shard_rule(cfg, mesh, batch=shape.global_batch, max_seq=shape.seq_len)
        cps = cache_pspecs(c_specs, mesh, batch=shape.global_batch, max_seq=shape.seq_len,
                           seq_split=rule is not None)
        layers = c_specs if isinstance(c_specs, list) else c_specs["self"] + c_specs["cross"]
        lspecs = cps if isinstance(cps, list) else cps["self"] + cps["cross"]
        for c, sp in zip(layers, lspecs):
            for n_, t in c.items():
                total += _numel(local_shape(tuple(t.shape), sp[n_], mesh)) * t.element_size()
    return total


@pytest.mark.parametrize("form", ["train", "train_fsdp", "decode", "decode_b1"])
@pytest.mark.parametrize("dm", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_argument_bytes_equal_the_layouts(arch, dm, form):
    cfg = get_smoke_config(arch)
    shape = KINDS[form.replace("_fsdp", "")]
    fsdp = form == "train_fsdp"
    mesh = make_abstract_mesh(*dm)
    _, _, got = dr.cell_step(cfg, shape, mesh, fsdp=fsdp)
    assert got == _expected_rank_bytes(cfg, shape, mesh, fsdp)


def test_a_block_holds_its_rows_alone():
    """``local_block`` of a leaf split on its leading dimension is a
    copy: the shard does not keep the whole leaf's storage alive."""
    from repro_torch.launch.sharding import LeafLayout, local_block

    mesh = meta_mesh(1, 4)
    w = torch.arange(64.0).reshape(16, 4)
    for spec in (("model", None), (None, "model")):
        b = local_block(w, LeafLayout("w", (16, 4), spec), mesh, (0, 2))
        assert b.untyped_storage().nbytes() == b.numel() * b.element_size() == 64
    assert torch.equal(local_block(w, LeafLayout("w", (16, 4), ("model", None)), mesh, (0, 2)),
                       w[8:12])


def test_one_moe_layer_tally_derived_by_hand():
    """qwen3-moe-30b-a3b at full width (two layers) on meta, B = 4 ×
    4,096, SP on: one layer's forward on rank (0, 0).  Each model-axis
    sum of a (B/D, S, d) bf16 partial output (the attention's and the
    experts', 2·(B/D)·S·d·2 bytes together: 67,108,864 B at (2, 2),
    134,217,728 B at (1, 4)) is, in the port's gather form, an
    all-gather of the M whole partials; SP gathers the residual's M
    blocks before each of the two; FSDP gathers each leaf of at least
    2²⁰ elements over 'data' before use."""
    cfg = get_config("qwen3-moe-30b-a3b").replace(n_layers=2)
    B, S, d = 4, 4096, cfg.d_model
    for (D, M), psum_bytes in (((2, 2), 67_108_864), ((1, 4), 134_217_728)):
        assert 2 * (B // D) * S * d * 2 == psum_bytes
        for fsdp in (False, True):
            tally = CollectiveTally()
            mesh = make_abstract_mesh(D, M, tally=tally)
            params = model_module(cfg).abstract_params(cfg)
            layouts = layer_layouts(cfg, mesh, fsdp=fsdp)
            shard_params(params, mesh, layouts)
            sh = parallel.Shard(mesh, layouts=layouts, params=params, sp=True)
            x = torch.empty((B // D, S // M, d), dtype=cfg.dtype, device="meta")
            with torch.no_grad():
                out = parallel._block("moe", params.blocks[0], [x], cfg, sh,
                                      positions=torch.arange(S, device="meta"), cache=None,
                                      cache_index=0, memory=None, lsh_shard=None)
            assert tuple(out[0].shape) == (B // D, S // M, d)
            gathers = psum_bytes // 2 * 2 + M * psum_bytes  # SP's two, the sums' two
            count = 4
            if fsdp and D > 1:
                for name, lay in layouts.items():
                    if name.startswith("blocks.0.") and "data" in lay.axes():
                        # the bf16 block gathered over 'data'
                        gathers += D * _numel(lay.local_shape(mesh)) * 2
                        count += 1
            assert tally.bytes == {"all-gather": gathers, "all-reduce": 0,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 0}
            assert tally.counts["all-gather"] == count and sum(tally.counts.values()) == count


def test_a_batch_1_decode_without_the_sharded_form_keeps_heads_on_model():
    """whisper-base (no PM-LSH decode) at B = 1 on (2, 2): the caches'
    sequence stays whole, so their kv heads lie on 'model' as the
    attention reads them, on every rank."""
    cfg = get_smoke_config("whisper-base")
    shape = InputShape("decode", 64, 1, "decode")
    for d in range(2):
        for m in range(2):
            step, args, _ = dr.cell_step(cfg, shape, make_abstract_mesh(2, 2, (d, m)))
            logits, caches = step(*args)
            assert tuple(logits.shape) == (1, 1, cfg.padded_vocab())
            assert caches["self"][0]["k"].shape[2] == cfg.n_kv_heads // 2
