"""The strict-view guard (``repro_torch.launch.strict_views``) on hymba
and whisper, as ``tests/test_torch_strict_views.py`` runs it on the
decoders: the full-width train step on a fake world of 256 ranks under
the (32, 8) mesh's train rules, with no ``_StridedShard``, no graph-based
redistribution plan and no dry-run fallback.

The cuts: hymba one global and one local layer (its pattern's two kinds)
on 2048 tokens a sequence, past its 1024-token window, so that the local
layer takes the sliding-window path; whisper one encoder and one decoder
block on 4096 decoder tokens (its 1500 encoder frames whole), the length
at which its sequence sharding showed; a batch of 256 sequences.  On the
parent commit of the repair these cuts counted (``_StridedShard``, graph
plans, fallbacks): hymba (59, 353, 0) at the Mamba scan's products (its
input's sequence sharded over ``model`` by the split of the in-projection)
and the logits' backward, whisper (88, 277, 6) with six ``aten.view``
fallbacks over ``model`` (a view of an uneven 1500-frame shard).  One
subprocess runs both; it imports only the port.
"""

import pytest

from test_torch_strict_views import check_record, guard_records

ARCHS = ("hymba_1_5b", "whisper_small")


@pytest.fixture(scope="module")
def records():
    return guard_records(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shards_with_no_strided_view(records, arch):
    """The architecture's full-width train step on the (32, 8) mesh: no
    ``_StridedShard``, no graph-based plan, no dry-run fallback."""
    check_record(records[arch], arch)
