"""The strict-view guard (``repro_torch.launch.strict_views``) on the
decoder architectures: each one's sharded train step traced at its full
config's widths on a fake world of 256 ranks, under the dry run's train
rules on the (32, 8) production mesh, with no ``_StridedShard``
constructed, no graph-based redistribution plan and no fallback of the
dry run (``replicated_to_propagate``).  A view that flattens a dim group
sharded on an inner dim is refused by DTensor on torch 2.11 and kept on
later releases as a ``_StridedShard``, whose plans take the min-cost graph
search; a fallback is an operation a real ``Trainer(rules=)`` cannot run.

The cuts (``strict_views.guard_config`` and ``SEQ``): one layer of each
kind the config has (gemma2 and gemma3 one local and one global layer,
the others one), full widths, a batch of 256 sequences of ``SEQ[arch]``
tokens: 4096 for Danube, gemma2 and gemma3 (past gemma3's 512-token
window), 512 for mixtral, grok, nemotron and chameleon.  On the parent
commit of the repair these cuts counted (``_StridedShard``, graph plans,
fallbacks): mixtral and grok (41, 253, 0) at the MoE's flattens and the
logits' product, gemma3 (19, 73, 0) and chameleon (38, 184, 0) at the
q/k projections' backward (the gradient's head dim sharded); Danube,
nemotron and gemma2 (0, 0, 0).

One subprocess runs every case of this file (the fake process group is
process-wide); it imports only the port, so the file runs on a card's
machine too (``PYTHONPATH=src python3 -m pytest -q
tests/test_torch_strict_views*.py``).
``tests/test_torch_strict_views_recurrent.py`` holds hymba and whisper,
``tests/test_torch_strict_views_xlstm.py`` xlstm.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mixtral_8x7b", "grok_1_314b", "h2o_danube_1_8b",
         "nemotron_4_340b", "gemma2_2b", "gemma3_1b", "chameleon_34b")


def guard_records(archs) -> dict:
    """{arch: the guard's record}, from one subprocess tracing ``archs``."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get(
        "PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
        "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.strict_views"]
    for a in archs:
        cmd += ["--arch", a]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    recs = {}
    for ln in res.stdout.splitlines():
        if ln.startswith("STRICT "):
            rec = json.loads(ln[len("STRICT "):])
            recs[rec["arch"]] = rec
    assert set(recs) == set(archs), res.stderr[-3000:]
    return recs


def check_record(rec: dict, arch: str) -> None:
    """Full widths, one layer of each kind, and the three counts at 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.strict_views import SEQ

    cfg = get_config(arch)
    want = ["global"] if cfg.family == "encdec" else list(
        dict.fromkeys(cfg.layer_pattern))
    assert rec["layers"] == want
    assert rec["seq"] == SEQ[arch] and rec["batch"] == 256
    assert rec["fallbacks"] == {}, rec["fallbacks"]
    assert rec["strided_shards"] == 0, rec
    assert rec["graph_plans"] == 0, rec


@pytest.fixture(scope="module")
def records():
    return guard_records(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shards_with_no_strided_view(records, arch):
    """The architecture's full-width train step on the (32, 8) mesh: no
    ``_StridedShard``, no graph-based plan, no dry-run fallback."""
    check_record(records[arch], arch)
