"""The strict-view guard (``repro_torch.launch.strict_views``) on xlstm,
as ``tests/test_torch_strict_views.py`` runs it on the decoders: the
full-width train step on a fake world of 256 ranks under the (32, 8)
mesh's train rules, with no ``_StridedShard``, no graph-based
redistribution plan and no dry-run fallback.

The cut: one mLSTM and one sLSTM layer, 512 tokens a sequence (two of
the mLSTM's 256-token chunks), a batch of 256 sequences; the sLSTM's loop
dispatches its DTensor operations once a token, most of the trace's time.
On the parent commit of the repair this cut counted 19 ``_StridedShard``
(the mLSTM's (heads, head dim) flatten with the head dim sharded, as its
output norm's scale is), 160 graph plans and no fallback.  One
subprocess; it imports only the port.
"""

import pytest

from test_torch_strict_views import check_record, guard_records

ARCH = "xlstm_350m"


@pytest.fixture(scope="module")
def records():
    return guard_records((ARCH,))


def test_train_step_shards_with_no_strided_view(records):
    """xlstm's full-width train step on the (32, 8) mesh: no
    ``_StridedShard``, no graph-based plan, no dry-run fallback."""
    check_record(records[ARCH], ARCH)
