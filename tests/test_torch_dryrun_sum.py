"""The dry run's abstract rank summed over the D·M ranks of a (2, 2)
group against the emulated mesh on the meta device, op by op
(``FlopCounterMode``): equal where nothing but the form differs, and
where they differ, each op and the reason.
"""
from __future__ import annotations

import pytest
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr
from repro_torch.launch import make_host_mesh
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import parallel

# one architecture a family: dense, moe, vlm, hybrid, ssm, encdec
FAMILIES = ["yi-6b", "qwen3-moe-30b-a3b", "llama32-vision-11b", "recurrentgemma-9b",
            "xlstm-125m", "whisper-base"]
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


# Where the FLOPs of the D·M ranks and of the emulated mesh differ at
# (2, 2), op by op, and why.
#   early stop   a rank's recompute of a remat unit stops after its last
#                saved tensor (torch.utils.checkpoint's early stop); the
#                emulated mesh runs the model shards in turn, so it
#                recomputes each shard's last matmul but the last one's
#                (the MLP's w_down): the ranks do fewer aten.mm.
#   whole block  a block whose work the axis does not divide (the xLSTM
#                blocks) runs on every rank of a group (every rank takes
#                part in its collectives); the emulated mesh runs it on
#                shard 0 alone (``Shard.skip``): the ranks do more.
#   replicated   a batch that does not split over 'data' runs on every
#                data shard of a group, the emulated mesh once; the
#                sequence-sharded PM-LSH decode splits its attention, so
#                the ranks do between one and D times the work.
CAUSES = {"early stop": ({"aten.mm"}, -1), "whole block": ({"aten.mm", "aten.bmm"}, 1),
          "replicated": ({"aten.mm", "aten.bmm"}, 1)}


def _sums(cfg, shape, D: int = 2, M: int = 2) -> tuple[dict, dict]:
    """(the D·M ranks' FLOPs summed, the emulated mesh's), op by op."""
    em = flops_by_op(*dr.cell_step(cfg, shape, meta_mesh(D, M))[:2])
    ranks = {}
    for d in range(D):
        for m in range(M):
            got = flops_by_op(*dr.cell_step(cfg, shape, make_abstract_mesh(D, M, (d, m)))[:2])
            for op, n in got.items():
                ranks[op] = ranks.get(op, 0) + n
    return ranks, em


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_flops_sum_to_the_emulated_mesh(arch, kind, monkeypatch):
    """With the first two causes off (``Shard.skip`` never skipping, the
    recompute run whole) the sums are equal op for op; a replicated
    batch leaves each op between the emulated count and D times it."""
    cfg = get_smoke_config(arch)
    monkeypatch.setattr(parallel.Shard, "skip", lambda self, counts: False)
    with set_checkpoint_early_stop(False):
        ranks, em = _sums(cfg, KINDS[kind])
    if kind == "decode_b1":
        assert ranks != em and all(em[op] <= ranks[op] <= 2 * em[op] for op in em)
        assert set(ranks) == set(em)
    else:
        assert ranks == em


@pytest.mark.parametrize("arch, kind, cause", [
    ("yi-6b", "train", "early stop"), ("xlstm-125m", "prefill", "whole block"),
    ("yi-6b", "prefill", None), ("whisper-base", "decode", None),
    ("whisper-base", "decode_b1", "replicated"), ("yi-6b", "decode_b1", "replicated")])
def test_where_the_rank_sum_differs(arch, kind, cause):
    """As the dry run runs (both causes on): the ops that differ and the
    direction, by cause; None where the sums are equal."""
    ranks, em = _sums(get_smoke_config(arch), KINDS[kind])
    differ = {op for op in set(ranks) | set(em) if ranks.get(op, 0) != em.get(op, 0)}
    if cause is None:
        assert not differ, (ranks, em)
        return
    ops, sign = CAUSES[cause]
    assert differ and differ <= ops, (ranks, em)
    assert all((ranks[op] - em[op]) * sign > 0 for op in differ)
