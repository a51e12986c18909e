"""The port's LM roofline (``repro_torch.analysis.roofline``) against the
reference's, and its pricing of a traced collective inventory.

* ``analytic_flops`` and ``analytic_traffic`` equal to the reference's for
  every arch x shape, at the dry run's chip counts and splits (one and two
  clusters; the functions are the reference's, copied as they are);
* ``ring_wire_bytes`` equal to the wire the reference's
  ``parse_collectives`` reads off HLO lines of each collective;
* a sharded product traced by the dry run's ``StepTrace`` on a (2, 4) fake
  mesh in a subprocess (the fake process group is process-wide): its
  FLOPs a device, its all-reduce over ``model`` and all-gather over
  ``data`` counted by hand, and each priced at NVLink's and InfiniBand's
  data-sheet rates.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as ref_configs
from repro.analysis.roofline import analytic_flops as ref_analytic_flops
from repro.analysis.roofline import analytic_traffic as ref_analytic_traffic
from repro.analysis.roofline import parse_collectives
from repro_torch import configs, hw
from repro_torch.analysis.roofline import (analytic_flops, analytic_traffic,
                                           link_rate, ring_wire_bytes,
                                           roofline_report)
from repro_torch.configs import SHAPES

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_analytic_flops_and_traffic_match_reference(arch, shape):
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    rshape = ref_configs.SHAPES[shape]
    assert analytic_flops(cfg, SHAPES[shape]) == ref_analytic_flops(rcfg,
                                                                    rshape)
    for chips in (256, 512):
        tp = 8
        fsdp = chips // tp if SHAPES[shape].kind == "train" else 1
        kw = dict(chips=chips, tp=tp, fsdp=fsdp, dp_total=chips // tp)
        assert analytic_traffic(cfg, SHAPES[shape], **kw) == \
            ref_analytic_traffic(rcfg, rshape, **kw)


HLO = {
    "all-gather": "%x = bf16[256,4096]{1,0} all-gather(bf16[32,4096] %a), "
                  "replica_groups=[32,8]<=[256], dimensions={0}",
    "reduce-scatter": "%x = f32[32,4096]{1,0} reduce-scatter(f32[256,4096] "
                      "%a), replica_groups=[32,8]<=[256], dimensions={0}",
    "all-reduce": "%x = f32[64,1024]{1,0} all-reduce(f32[64,1024] %a), "
                  "replica_groups=[8,32]<=[256]",
    "all-to-all": "%x = bf16[8,512,128]{2,1,0} all-to-all(bf16[8,512,128] "
                  "%a), replica_groups=[32,8]<=[256], dimensions={0}",
    "collective-permute": "%x = f32[16,128]{1,0} collective-permute(f32[16,"
                          "128] %a), source_target_pairs={{0,1},{1,0}}",
}


@pytest.mark.parametrize("op", list(HLO))
def test_ring_formulas_are_the_reference_s(op):
    (rec,) = parse_collectives(HLO[op])
    assert rec["op"] == op
    assert ring_wire_bytes(op, rec["bytes"], rec["group"]) == rec["wire"]


def test_links_by_mesh_axis():
    assert link_rate(["model"]) == hw.H100.nvlink_bandwidth == 450e9
    assert link_rate(["data"]) == hw.H100.network_bandwidth == 50e9
    assert link_rate(["pod"]) == link_rate(["data", "model"]) == 50e9


SCRIPT = r"""
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import StepTrace, fake_world

with fake_world(8):
    mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))
    # A (64, 4096) rows over data; W (4096, 1024) rows over model (the
    # contraction split four ways): y = A @ W is a partial sum over model
    a = DTensor.from_local(torch.empty(32, 4096, dtype=torch.bfloat16,
                                       device="meta"),
                           mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(1024, 1024, dtype=torch.bfloat16,
                                       device="meta"),
                           mesh, [Replicate(), Shard(0)], run_check=False)
    trace = StepTrace(mesh)
    with trace:
        y = a @ w
        y = y.redistribute(mesh, [Shard(0), Replicate()])   # all-reduce
        y = y.redistribute(mesh, [Replicate(), Replicate()])  # all-gather
    print("TRACE " + json.dumps({"flops": trace.flops,
                                 "collectives": trace.collectives,
                                 "replicated": [p.is_replicate() for p in
                                                y.placements]}))
"""


def test_traced_sharded_product_is_priced_by_hand():
    """y = A @ W with A's rows over ``data`` (2) and the contraction over
    ``model`` (4): each device multiplies (32 x 1024) by (1024 x 1024):
    2·32·1024·1024 FLOPs; summing the partial products is an all-reduce
    of the local (32, 1024) bf16 result, 65536 bytes, over 4 cards of a
    node's NVLink (wire 2·b·3/4); gathering the rows is an all-gather of
    (64, 1024) bf16, 131072 bytes, over 2 nodes' InfiniBand (wire b/2)."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp")}
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("TRACE "))
    got = json.loads(line[len("TRACE "):])
    assert got["flops"] == 2 * 32 * 1024 * 1024
    assert got["collectives"] == [
        {"op": "all-reduce", "bytes": 65536, "group": 4, "axes": ["model"]},
        {"op": "all-gather", "bytes": 131072, "group": 2, "axes": ["data"]}]
    assert got["replicated"] == [True, True]
    rep = roofline_report(chips=8, collectives=got["collectives"],
                          flops_per_dev=got["flops"], bytes_per_dev=0)
    ar, ag = (rep["collectives"][k] for k in ("all-reduce over model",
                                              "all-gather over data"))
    assert ar["wire"] == 2 * 65536 * 3 // 4
    assert ag["wire"] == 131072 // 2
    assert ar["seconds"] == pytest.approx(98304 / 450e9)
    assert ag["seconds"] == pytest.approx(65536 / 50e9)
    terms = rep["terms_traced"]
    assert terms["compute_s"] == pytest.approx(2 * 32 * 1024 * 1024 / 989e12)
    assert terms["collective_s"] == pytest.approx(98304 / 450e9
                                                  + 65536 / 50e9)
    assert rep["wire_per_dev_nvlink"] == 98304
