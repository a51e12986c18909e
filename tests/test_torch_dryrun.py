"""The port's LM dry run: its machinery on a small fake mesh, and its
sharding rules against the reference's.

* The reference's seven cases of ``tests/test_dryrun_small.py`` (smoke
  configs of five families, every step kind) traced on a (2, 4) mesh of
  8 fake ranks in one subprocess (the fake process group is
  process-wide), each with status ``ok``, memory, analytic FLOPs and a
  roofline whose collectives are priced per mesh axis.
* ``param_specs`` against the reference's ``param_specs`` for every leaf
  of every arch's full config (shapes only: ``jax.eval_shape`` there, the
  meta device here) under the dry run's train and serve rules on the
  (32, 8) and (2, 32, 8) meshes, and in the serving layout of decode
  cells; the leaves whose stacked spec the reference shards over the
  layer axis are listed with their bytes a device under both.
* ``cache_specs`` against the reference's for every cache leaf of every
  arch's decode_32k cell.
"""

import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist.sharding import ShardingRules as RefRules
from repro.dist.sharding import cache_specs as ref_cache_specs
from repro.dist.sharding import param_specs as ref_param_specs
from repro.launch.specs import params_shapes as ref_params_shapes
from repro.models import init_cache as ref_init_cache
from repro.models.whisper import whisper_init_cache as ref_whisper_cache
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.dist.sharding import (STACKS, ShardingRules, cache_specs,
                                       param_specs, shard_activation,
                                       stacked_spec)
from repro_torch.launch.dryrun import cell_is_skipped
from repro_torch.launch.specs import params_shapes
from repro_torch.models import init_cache
from repro_torch.models.whisper import whisper_init_cache

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.dryrun import fake_world, trace_cell

CASES = [
    ("h2o_danube_1_8b", ShapeConfig("train", 64, 8, "train"), "train"),
    ("mixtral_8x7b", ShapeConfig("train", 64, 8, "train"), "train"),
    ("gemma3_1b", ShapeConfig("prefill", 64, 8, "prefill"), "serve"),
    ("hymba_1_5b", ShapeConfig("decode", 64, 8, "decode"), "serve"),
    ("xlstm_350m", ShapeConfig("decode", 64, 8, "decode"), "serve"),
    ("whisper_small", ShapeConfig("train", 64, 8, "train"), "train"),
    ("nemotron_4_340b", ShapeConfig("decode", 64, 8, "decode"), "serve"),
]
out = {}
with fake_world(8):
    mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
    for arch, shape, kind in CASES:
        rules = ShardingRules(mesh=mesh, tp="model",
                              fsdp="data" if kind == "train" else None,
                              dp=("data",))
        out[arch] = trace_cell(get_smoke(arch), shape, rules)
print("RECORDS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def small_mesh_records():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp")}
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):])


@pytest.mark.parametrize("arch,kind", [
    ("h2o_danube_1_8b", "train"), ("mixtral_8x7b", "train"),
    ("gemma3_1b", "prefill"), ("hymba_1_5b", "decode"),
    ("xlstm_350m", "decode"), ("whisper_small", "train"),
    ("nemotron_4_340b", "decode")])
def test_dryrun_machinery_small_mesh(small_mesh_records, arch, kind):
    """Each case traces with status ok: argument bytes from the local
    shards, a step peak, FLOPs counted, and collectives over the mesh's
    axes, each priced (``model`` at NVLink's rate, ``data`` at
    InfiniBand's)."""
    rec = small_mesh_records[arch]
    assert rec["status"] == "ok" and rec["chips"] == 8
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["peak_step_bytes"] > 0
    assert mem["per_device_total"] == (mem["argument_bytes"]
                                       + mem["peak_step_bytes"])
    assert rec["analytic_flops"]["model_flops"] > 0
    roof = rec["roofline"]
    assert roof["traced_flops_per_dev"] > 0
    assert roof["traced_bytes_per_dev"] > 0
    for t in ("terms_traced", "terms_primary"):
        assert roof[t]["dominant"] in ("compute", "memory", "collective")
    assert roof["collectives"], "no collective recorded"
    axes = {k.split(" over ")[1] for k in roof["collectives"]}
    assert "model" in axes
    if kind == "train":
        assert "data" in axes     # FSDP gathers and gradient reductions
    for k, c in roof["collectives"].items():
        rate = 450e9 if k.endswith("over model") else 50e9
        assert c["seconds"] == pytest.approx(c["wire"] / rate), k
    if kind == "train":
        assert rec["microbatches"] >= 1


# --------------------------------------------------------------------------
# sharding rules against the reference's
# --------------------------------------------------------------------------

#: the dry run's rules, (mesh shape, axis names, tp, fsdp, dp)
RULES = {
    "train": ((32, 8), ("data", "model"), "model", "data", ("data",)),
    "serve": ((32, 8), ("data", "model"), "model", None, ("data",)),
    "train_2pod": ((2, 32, 8), ("pod", "data", "model"), "model", "data",
                   ("pod", "data")),
    "serve_2pod": ((2, 32, 8), ("pod", "data", "model"), "model", None,
                   ("pod", "data")),
    "dp_remap": ((32, 8), ("data", "model"), None, ("data", "model"),
                 ("data", "model")),
}

#: every leaf whose stacked spec the reference shards over the layer axis
#: (FSDP over 'data' lands on L, the largest dim it divides once TP took
#: d) under the train rules, single or two pods alike: (arch, leaf) ->
#: (the reference's stacked spec, the port's per-layer spec, the stack's
#: bytes a device in float32 there, all layers' bytes a device here).
#: The port has no layer axis, so these leaves stay replicated over
#: 'data': 32x the bytes, at most 0.9 MB a device (nemotron's norms).
LAYER_AXIS = {
    ("mixtral_8x7b", "blocks.ln1.scale"):
        (("data", "model"), ("model",), 2048, 65536),
    ("mixtral_8x7b", "blocks.ln2.scale"):
        (("data", "model"), ("model",), 2048, 65536),
    ("grok_1_314b", "blocks.ln1.scale"):
        (("data", "model"), ("model",), 6144, 196608),
    ("grok_1_314b", "blocks.ln2.scale"):
        (("data", "model"), ("model",), 6144, 196608),
    ("nemotron_4_340b", "blocks.ln1.scale"):
        (("data", "model"), ("model",), 27648, 884736),
    ("nemotron_4_340b", "blocks.ln1.bias"):
        (("data", "model"), ("model",), 27648, 884736),
    ("nemotron_4_340b", "blocks.ln2.scale"):
        (("data", "model"), ("model",), 27648, 884736),
    ("nemotron_4_340b", "blocks.ln2.bias"):
        (("data", "model"), ("model",), 27648, 884736),
    ("hymba_1_5b", "blocks.ln1.scale"):
        (("data", "model"), ("model",), 800, 25600),
    ("hymba_1_5b", "blocks.ln2.scale"):
        (("data", "model"), ("model",), 800, 25600),
    ("hymba_1_5b", "blocks.ssm.conv_w"):
        (("data", None, "model"), (None, "model"), 6400, 204800),
    ("hymba_1_5b", "blocks.ssm.conv_b"):
        (("data", "model"), ("model",), 1600, 51200),
    ("hymba_1_5b", "blocks.ssm.w_dt"):
        (("data", "model", None), ("model", None), 1600, 51200),
    ("hymba_1_5b", "blocks.ssm.dt_bias"):
        (("data", "model"), ("model",), 1600, 51200),
    ("hymba_1_5b", "blocks.ssm.D_skip"):
        (("data", "model"), ("model",), 1600, 51200),
}


def _rules(name):
    shape, names, tp, fsdp, dp = RULES[name]
    ref = RefRules(mesh=types.SimpleNamespace(shape=dict(zip(names, shape))),
                   tp=tp, fsdp=fsdp, dp=dp)
    port = ShardingRules(mesh=types.SimpleNamespace(shape=shape,
                                                    mesh_dim_names=names),
                         tp=tp, fsdp=fsdp, dp=dp)
    return ref, port, dict(zip(names, shape))


def _flat(tree, is_leaf=None):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _full(spec, rank):
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


def _shards(spec, sizes):
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= sizes[a]
    return n


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, unstacked=False):
    cfg = ref_configs.get_config(arch)
    return ref_params_shapes(cfg, inference=unstacked, unstacked=unstacked)


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_param_specs_match_reference(arch, rules):
    """Every leaf of the full config: a non-block leaf's spec equals the
    reference's; a block leaf's is the reference's stacked spec with the
    layer entry dropped, except the LAYER_AXIS leaves, listed with their
    bytes a device."""
    ref_rules, port_rules, sizes = _rules(rules)
    rshapes = _ref_shapes(arch)
    ref = _flat(ref_param_specs(ref_configs.get_config(arch), rshapes,
                                ref_rules),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    shapes = {k: a.shape for k, a in _flat(rshapes).items()}
    cfg = configs.get_config(arch)
    mine = param_specs(cfg, params_shapes(cfg), port_rules)
    seen, layer_axis = set(), {}
    for name, spec in mine.items():
        parts = name.split(".")
        stacked = parts[0] in STACKS
        rname = ".".join([parts[0]] + parts[2:]) if stacked else name
        want = _full(ref[rname], len(shapes[rname]))
        seen.add(rname)
        if not stacked:
            assert spec == want, name
            continue
        assert stacked_spec(cfg, name, shapes[rname][1:], port_rules) \
            == want, name
        if want[0] is None:
            assert spec == want[1:], name
        elif parts[1] == "0":
            n = shapes[rname][0]
            ref_b = int(np.prod(shapes[rname])) * 4 // _shards(want, sizes)
            port_b = n * int(np.prod(shapes[rname][1:])) * 4 // _shards(
                spec, sizes)
            layer_axis[(arch, rname)] = (want, spec, ref_b, port_b)
    assert seen == set(shapes)
    expect = ({k: v for k, v in LAYER_AXIS.items() if k[0] == arch}
              if rules in ("train", "train_2pod") else {})
    assert layer_axis == expect


@pytest.mark.parametrize("arch", [a for a in ref_configs.ARCHS
                                  if ref_configs.get_config(a).family
                                  != "encdec"])
def test_serving_layout_specs_match_reference(arch):
    """A decode cell's per-layer layout: each leaf's spec equals the
    reference's spec of its ``unstacked`` leaf, under the serve rules."""
    ref_rules, port_rules, _ = _rules("serve")
    rshapes = _ref_shapes(arch, unstacked=True)
    ref = _flat(ref_param_specs(ref_configs.get_config(arch), rshapes,
                                ref_rules),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    shapes = {k: a.shape for k, a in _flat(rshapes).items()}
    cfg = configs.get_config(arch)
    mine = param_specs(cfg, params_shapes(cfg, inference=True), port_rules,
                       per_layer=True)
    for name, spec in mine.items():
        rname = name.replace("blocks.", "layers.", 1)
        assert spec == _full(ref[rname], len(shapes[rname])), name


@pytest.mark.parametrize("rules", ["serve", "serve_2pod"])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_cache_specs_match_reference(arch, rules):
    """Every cache leaf of the arch's decode_32k cell (KV caches, ring
    buffers, Mamba and xLSTM states, Whisper's cross k/v)."""
    if cell_is_skipped(arch, "decode_32k"):
        pytest.fail("decode_32k is never skipped")
    ref_rules, port_rules, _ = _rules(rules)
    shape = SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    if cfg.family == "encdec":
        rshapes = jax.eval_shape(functools.partial(ref_whisper_cache, rcfg,
                                                   B, S))
        mine = whisper_init_cache(cfg, B, S, device="meta")
    else:
        rshapes = jax.eval_shape(functools.partial(ref_init_cache, rcfg, B,
                                                   S))
        mine = init_cache(cfg, B, S, device="meta")
    ref = _flat(ref_cache_specs(rcfg, rshapes, ref_rules),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    want_shapes = {k: a.shape for k, a in _flat(rshapes).items()}
    got_shapes = {k: tuple(t.shape) for k, t in _flat(mine).items()}
    assert got_shapes == want_shapes
    got = _flat(cache_specs(cfg, mine, port_rules), is_leaf=_is_spec)
    assert set(got) == set(ref)
    for k, spec in got.items():
        assert spec == _full(ref[k], len(want_shapes[k])), k


def _is_spec(s) -> bool:
    """A spec: a tuple of None, axis names and tuples of axis names."""
    return isinstance(s, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in s)


def test_shard_activation_is_a_no_op_outside_a_context():
    x = torch.ones(4, 8, 16)
    assert shard_activation(x, "residual") is x
    assert shard_activation(x, "logits") is x


def test_skipped_cells_are_the_reference_s():
    """The reference's rule, read from its source: its module sets
    XLA_FLAGS on import, so it is not imported here."""
    import ast

    tree = ast.parse((ROOT / "src" / "repro" / "launch" /
                      "dryrun.py").read_text())
    full = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "FULL_ATTN_ARCHS")
    for arch in ref_configs.ARCHS:
        for shape in SHAPES:
            skipped = shape == "long_500k" and arch in full
            assert bool(cell_is_skipped(arch, shape)) == skipped, (arch,
                                                                   shape)
