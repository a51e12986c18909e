"""The counts behind ``chip_smoke.py``'s training bounds, on the CPU: the
operations of one training step of the decoder smoke configs against a
count made by hand (matrix products over the active parameters, attention
by layer kind), the full-size figures the card's records are held to, and
the profiler ranges of the family training phase."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402

T = 64          # tokens of the one sequence a step
# (query, key) pairs a head: the band of a window of 16 over 64 tokens
# (1 + 2 + ... + 16, then 16 for each of the 48 rows after), and the causal
# triangle of 64
BAND = 16 * 17 // 2 + 48 * 16          # 904
TRIANGLE = 64 * 65 // 2                # 2080
# a layer's forward attention at d 64 over 4 heads of 16: 4·D a pair a head
PAIR = 4 * 16 * 4
# the smoke weights (d 64, 4 heads over 2 KV heads of 16, d_ff 128, vocab
# 256): attention wq, wk, wv, wo; a gated MLP (or one expert); two norms
ATTN = 64 * 64 + 2 * 64 * 2 * 16 + 4 * 16 * 64    # 12288
MLP = 2 * 64 * 128 + 128 * 64                     # 24576
NORMS = 2 * 64
EMBED = 256 * 64

HAND = {
    # two local layers, tied embeddings
    "h2o_danube_1_8b": 6 * (2 * (ATTN + MLP + NORMS) + EMBED) * T
    + 2 * 3 * PAIR * BAND,
    # two local layers, 2 of 4 experts active a token (the router and the
    # untied head counted), the band on both
    "mixtral_8x7b": 6 * (2 * (ATTN + 2 * MLP + 64 * 4 + NORMS)
                         + 2 * EMBED) * T + 2 * 3 * PAIR * BAND,
    # a global and a local layer, each with the Mamba head (d_inner 128:
    # in, out, and conv 4 + 2 x state 8 + 2 a channel): the triangle on
    # layer 0, the band on layer 1
    "hymba_1_5b": 6 * (2 * (ATTN + MLP + NORMS + 2 * 64 * 128 + 128 * 64
                            + 128 * (4 + 2 * 8 + 2)) + EMBED) * T
    + 3 * PAIR * (TRIANGLE + BAND),
    # an mLSTM and an sLSTM layer (the analytic count's attention-shaped
    # weights at 4 KV heads and its cells at d_inner 128), no attention
    "xlstm_350m": 6 * (2 * (64 * 64 + 2 * 64 * 64 + 64 * 64 + NORMS
                            + 2 * 64 * 128 + 128 * 64 + 4 * 128 * 16)
                       + EMBED) * T,
}


@pytest.mark.parametrize("arch", sorted(HAND))
def test_train_step_ops_match_a_hand_count(arch):
    assert chip_smoke.train_step_ops(get_smoke(arch), T) == HAND[arch]


def test_train_step_bound_keeps_danube_and_counts_active_experts():
    """Danube's full-size step (no experts, every layer local) keeps its
    105.70 ms; mixtral's counts 2 of 8 experts a token, so its depth-2
    bound is about a third of what all eight would give."""
    assert round(chip_smoke.train_step_bound_ms(
        get_config("h2o_danube_1_8b"), 8192), 2) == 105.70
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=2)
    assert round(chip_smoke.train_step_bound_ms(cfg, 8192), 2) == 54.72
    every = dataclasses.replace(cfg, top_k=cfg.n_experts)
    assert chip_smoke.train_step_bound_ms(every, 8192) > \
        2.9 * chip_smoke.train_step_bound_ms(cfg, 8192)


def test_whisper_step_ops_match_a_hand_count():
    """The smoke whisper (2 + 2 layers, d 64, 4 heads of 16, d_ff 128,
    vocab padded to 256, 32 frames) on 2 utterances and 8 tokens."""
    cfg = get_smoke("whisper_small")
    attn = 4 * 64 * 64
    mlp = 2 * 64 * 128
    per_frame = 64 * 64 + 2 * (attn + mlp) + 2 * 2 * 64 * 64
    per_token = 2 * (attn + 2 * 64 * 64 + mlp) + 256 * 64
    pairs = 2 * 32 * 32 + 2 * (8 * 9 // 2 + 8 * 32)
    want = 6 * 2 * (32 * per_frame + 8 * per_token) + 3 * PAIR * 2 * pairs
    assert chip_smoke.whisper_step_ops(cfg, 2, 8) == want


def test_module_ranges_wrap_and_restore_the_family_modules():
    """Inside the block each family module runs in its profiler range and
    gives what it gives outside; after it the modules are the originals."""
    import torch

    from repro_torch.models import ssm, transformer

    names = [(transformer, "moe_apply")] + [
        (ssm, f"{c}_apply") for c in ("mamba", "mlstm", "slstm")]
    before = [getattr(m, n) for m, n in names]
    cfg = get_smoke("xlstm_350m")
    p = ssm.SLSTM(cfg.d_model, cfg.n_heads, torch.Generator().manual_seed(0))
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1))
    want, _ = ssm.slstm_apply(p, x)
    with chip_smoke.module_ranges(torch):
        assert all(getattr(m, n) is not f
                   for (m, n), f in zip(names, before))
        with torch.profiler.profile() as prof:
            got, _ = ssm.slstm_apply(p, x)
    assert torch.equal(got, want)
    assert any(e.name == "slstm" for e in prof.events())
    assert [getattr(m, n) for m, n in names] == before


def test_device_profile_reads_ranges_from_the_raw_events():
    """``device_profile`` on CPU work (no kernel to count): each range's
    host ms from its raw events, each label there, none for a label that
    never ran, and no kernel launches."""
    import types

    import torch

    shim = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None), _C=torch._C)
    x = torch.randn(64, 64)

    def work():
        for label in ("mamba", "moe", "mamba"):
            with torch.profiler.record_function(label):
                for _ in range(20):
                    x @ x
    out = chip_smoke.device_profile(work, shim, chip_smoke.FAMILY_RANGES)
    assert out["kernel_launches"] == 0 and out["device_ms"] == 0.0
    host = out["host_ms_by_range"]
    assert host["mamba"] > 0 and host["moe"] > 0
    assert host["mlstm"] == host["slstm"] == 0.0
    assert host["mamba"] + host["moe"] <= out["host_ms"]
    assert set(out["device_ms_by"]) >= {"swa", "swa_bwd", "matmul", "other",
                                        "moe_dispatch", "scan"}
