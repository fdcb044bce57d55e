"""The port's one-card dry run (``launch/dryrun.py``) on the CPU: meta
traces of the port's own steps, their counts against a real run's, the
probes' extrapolation against a full-depth trace, and the records' keys
against the JAX package's dry run.

Tiers: exact for operations (a meta trace against ``FlopCounterMode`` on
a real CPU step; the probes' extrapolation against the full-depth trace,
held at 1% and measured equal to 1e-15); the microbatch extrapolation
against a trace of every microbatch, exact in every count; the probes'
bytes within 10% of the full-depth trace's (measured 2.5% low at 6
reduced layers of h2o-danube-3-4b, equal at 7 slots of zamba2-7b: a
training step reads each layer's parameters as a
slice of the stacked leaves, and autograd adds each layer's gradient
into a gradient of the whole stack, bytes quadratic in depth that two
shallow probes cannot see).
"""
import dataclasses
import json

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode

from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import visible_pairs
from repro_torch.launch import dryrun, roofline
from repro_torch.models import build_model, init_tree
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step, to_device

SEQ, BATCH = 128, 4
KERNEL_OPS = ("repro_torch.flash_attention_meta",
              "repro_torch.flash_attention_bwd_meta",
              "repro_torch.ssd_scan_meta", "repro_torch.ssd_scan_bwd_meta")
PROBE_BYTES_TOL = 0.10


def _train_shape(batch=BATCH):
    return ShapeConfig("train_small", SEQ, batch, "train")


def test_meta_trace_counts_the_cpu_steps_products():
    """The reduced h2o-danube-3-4b's train step (remat "full"): the
    products outside attention equal a real CPU step's count; attention is
    the kernels' own count, visible pairs only, where the CPU's plain
    route multiplies every (query, key) pair."""
    cfg = get_arch("h2o-danube-3-4b", reduced=True)
    traced = dryrun.lower_cell(cfg, _train_shape())
    bundle = build_model(cfg)
    params = init_tree(bundle.decls, torch.Generator().manual_seed(0), "cpu")
    batch = to_device(SyntheticLM(LMDataConfig(cfg.vocab_size, SEQ, BATCH,
                                               seed=0)).batch(0), "cpu")
    step = make_train_step(bundle, OptConfig())
    with FlopCounterMode(display=False) as counted:
        step(params, init_opt_state(params, OptConfig()), batch)
    cpu = {str(k): v for k, v in counted.get_flop_counts()["Global"].items()}
    meta = traced["flops_by_op"]
    a = cfg.attention
    lanes, layers = BATCH * a.n_heads, cfg.n_layers
    # the plain route: q k' and p v in the forward and its recompute, four
    # products in the backward, over every pair
    assert cpu["aten.bmm"] == layers * lanes * SEQ * SEQ * 2 * a.head_dim * 8
    assert sum(cpu.values()) - cpu["aten.bmm"] == \
        traced["flops"] - sum(meta.get(k, 0) for k in KERNEL_OPS)
    pairs = visible_pairs(SEQ, SEQ, a.causal, a.sliding_window)
    d = a.head_dim
    assert meta["repro_torch.flash_attention_meta"] == \
        2 * layers * lanes * pairs * 2 * (d + d)
    assert meta["repro_torch.flash_attention_bwd_meta"] == \
        layers * lanes * pairs * 2 * (3 * d + 2 * d)


def test_meta_trace_launches_nothing():
    before = dict(runtime.launch_counts)
    cfg = get_arch("zamba2-7b", reduced=True)
    traced = dryrun.lower_cell(cfg, _train_shape())
    assert runtime.launch_counts == before
    assert traced["flops_by_op"]["repro_torch.ssd_scan_meta"] > 0
    assert traced["flops_by_op"]["repro_torch.ssd_scan_bwd_meta"] > 0
    assert traced["flops_by_op"]["repro_torch.flash_attention_meta"] > 0


def test_microbatch_extrapolation_is_exact():
    cfg = get_arch("h2o-danube-3-4b", reduced=True)
    shape = _train_shape(batch=4)
    every = dryrun._trace(cfg, shape, 1024, "full", 4)
    extrapolated = dryrun.lower_cell(cfg, shape, n_microbatch=4)
    for k in dryrun._COUNTS:
        assert extrapolated[k] == every[k], k


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-7b"])
def test_probes_extrapolate_to_the_full_depth(arch):
    cfg = get_arch(arch, reduced=True)
    per = cfg.shared_attn_every or 1
    cfg = dataclasses.replace(cfg, n_layers=2 * per + (1 if per > 1 else 4))
    shape = _train_shape()
    full = dryrun.lower_cell(cfg, shape)
    plan = roofline.probe_plan(cfg)
    probes = [dryrun.lower_cell(p, shape) for p, _ in plan.probes]
    got = roofline.solve_extrapolation(
        plan, [{k: c[k] for k in ("flops", "bytes")} for c in probes])
    assert abs(got["flops"] - full["flops"]) <= 0.01 * full["flops"]
    assert abs(got["bytes"] - full["bytes"]) <= PROBE_BYTES_TOL * full["bytes"]


def test_a_cells_record_has_the_references_keys(tmp_path):
    dryrun.main(["--arch", "xlstm-350m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "yi-34b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "xlstm-350m__long_500k__single.json")
                     .read_text())
    # the reference's keys, its compile times replaced by the trace's
    assert {"arch", "shape", "mesh", "variant", "full", "roofline",
            "probe_costs", "params", "active_params", "wall_s"} <= set(rec)
    assert {"trace_s", "arg_bytes", "temp_bytes", "output_bytes",
            "alias_bytes", "peak_bytes", "fits_hbm",
            "collective_ops"} <= set(rec["full"])
    assert rec["full"]["collective_ops"] == {}
    full = rec["full"]
    assert full["peak_bytes"] == full["arg_bytes"] + full["temp_bytes"] \
        + full["output_bytes"] - full["alias_bytes"]
    assert full["fits_hbm"] == (full["peak_bytes"] <= dryrun.HBM_PER_CHIP)
    assert set(rec["roofline"]) == set(
        roofline.RooflineTerms(1.0, 1.0, 0.0, 1, 1.0).to_dict())
    assert rec["roofline"]["coll_bytes_per_dev"] == 0.0
    skipped = json.loads((tmp_path / "yi-34b__long_500k__single.json")
                         .read_text())
    assert skipped["skipped"] is True and "500k" in skipped["reason"]


def test_more_than_one_card_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.main(["--arch", "xlstm-350m", "--shape", "train_4k",
                     "--mesh", "multi"])
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.run_cell("xlstm-350m", "train_4k", "multi")


def test_microbatches_take_the_references_budget():
    cfg = get_arch("h2o-danube-3-4b")
    small = get_arch("whisper-base")
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    assert dryrun.microbatches(cfg, shape) == 64        # 1M tokens / 16k
    assert dryrun.microbatches(small, shape) == 16      # / 64k
    # 72k tokens: 4 micro of 16k, which must divide the batch of 6
    assert dryrun.microbatches(cfg, ShapeConfig("t", 12288, 6, "train")) == 3


def test_probe_plan_depths_stay_small():
    for arch in ("h2o-danube-3-4b", "zamba2-7b", "whisper-base"):
        plan = roofline.probe_plan(get_arch(arch))
        assert max(max(c.n_layers, c.n_encoder_layers)
                   for c, _ in plan.probes) <= 12
        assert np.all(np.asarray(plan.full_trips) >= 0)
