"""One-card dry run: for an (architecture x input shape) cell, whether its
step fits one card, and its roofline terms, without running it.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on
host devices and reads XLA's memory and cost analyses.  Here the step is
traced instead, on the ``meta`` device: parameters, optimizer state,
batch and cache are meta tensors of their declared shapes and types, and
the step is the port's own — the train step of ``train/trainer.py``
(``make_train_step``: autograd, rematerialisation, microbatches,
AdamW), ``prefill_fn`` or ``decode_fn``.  Attention and the SSD scan take
the card's route, whose launches are shape-only stand-ins on meta
tensors (``kernels/flash_attention.py``, ``kernels/ssd_scan.py``).  It
launches nothing and needs no GPU — the one entry point of the port that
does not default to the card, because it computes on none.

What a trace counts:

* operations: ``torch.utils.flop_counter.FlopCounterMode`` — the matrix
  products (2 a multiply-add), and the kernels' own operations by their
  stand-ins' formulas (flash attention 2 (D + Dv) a visible (query, key)
  pair forward and 2 (3 D + 2 Dv) backward; the SSD scan 5 N P a row and
  lane forward and 11 N P backward).  Elementwise operations, norms,
  softmax outside the kernels and reductions count nothing, as the flop
  counter counts them;
* bytes: every operator's inputs read once and its outputs written once
  (``StepCounter``), with no fusion — XLA's "bytes accessed" before
  fusion; views, detaches and allocations move nothing;
* memory: every storage from its creation to its release, and the
  largest sum of those alive (``peak_bytes``), the step's arguments
  included; the card's caching allocator's rounding and fragmentation are
  not counted.

What it does not count: the sLSTM's time loop is stepped once on meta
tensors and its operations added by ``roofline.analytic_extra_flops``, as
the reference adds those its compiler saw once; the stand-ins' own
scratch reads and writes (their bytes are the function's); collectives
(one card has none).

As in the reference, a cell's memory comes from its step at full depth,
and its operations and bytes from probes: the step traced at the small
depths of ``roofline.probe_plan``, the counts extrapolated linearly to
the full depth (``solve_extrapolation``); ``--skip-probes`` takes them
from the full-depth trace.  The extrapolation is exact for operations.
Bytes carry a term the probes miss: each layer reads its parameters as a
slice of the stacked leaves, and autograd adds each layer's gradient into
a gradient of the whole stack, so a training step moves bytes quadratic
in depth.  The reference's shapes are sized for a pod, so most cells do
not fit one card: the record says so (``fits_hbm`` false).

The CLI is the reference's.  ``--mesh multi`` raises (item 10).
``--attn-chunk`` and the variants' ``attn_chunk`` set the CPU route's
key chunks; the card's kernel, which the trace stands in for, tiles on
its own, so they change no count here.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b --shape train_4k
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, SHAPE_BY_NAME, SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.launch.roofline import (
    RooflineTerms, analytic_extra_flops, model_flops, probe_plan,
    solve_extrapolation,
)
from repro_torch.models import build_model
from repro_torch.models.param import tree_map
from repro_torch.sharding.policy import apply_variant
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

# the card's memory: torch.cuda.get_device_properties(0).total_memory of
# an NVIDIA H100 80GB HBM3 (chip_smoke.py's device phase)
HBM_PER_CHIP = 85_017_493_504

# operators that allocate without writing
_ALLOCATIONS = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.new_empty.default, torch.ops.aten.empty_strided.default,
    torch.ops.aten.new_empty_strided.default})


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _read_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes, at most its storage's (an expanded view reads
    its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepCounter(TorchDispatchMode):
    """Bytes the operators read and write, and the live storages' bytes
    and their peak, over the operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, tuple] = {}

    def key(self, t: torch.Tensor) -> int:
        """The identity of ``t``'s storage."""
        return StorageWeakRef(t.untyped_storage()).cdata

    def _known(self, key: int) -> bool:
        """Whether ``key`` is a counted storage that is still alive (a
        released storage's key may come back for a new one)."""
        entry = self._live.get(key)
        if entry is not None and entry[0].expired():
            self.live_bytes -= self._live.pop(key)[1]
            return False
        return entry is not None

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` alive (those not yet counted);
        their bytes."""
        added = 0
        for t in tensors:
            key = self.key(t)
            if self._known(key):
                continue
            n = t.untyped_storage().nbytes()
            self._live[key] = (StorageWeakRef(t.untyped_storage()), n)
            added += n
        if added:
            self._sweep()
            self.live_bytes += added
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    def storage_bytes(self, tensors) -> int:
        """The bytes of the distinct storages of ``tensors``."""
        seen = {}
        for t in tensors:
            seen[self.key(t)] = t.untyped_storage().nbytes()
        return sum(seen.values())

    def _sweep(self):
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self.live_bytes -= self._live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        new = [t for t in outs if not self._known(self.key(t))]
        if func not in _ALLOCATIONS and (new or func._schema.is_mutable):
            self.bytes += sum(_read_bytes(t) for t in ins) \
                + sum(t.numel() * t.element_size() for t in outs)
        self.track(new)
        return out


def _meta_tree(decls):
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls)


def microbatches(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation factor on one card (data parallelism 1): the
    reference's cap of a device's micro tokens, ~16k for models past 2 B
    parameters (activation checkpoints and attention transients grow
    with them), 64k below."""
    tokens = shape.tokens
    budget = 16_384 if cfg.param_count() > 2e9 else 65_536
    m = max(1, tokens // budget)
    while shape.global_batch % m and m > 1:   # micro must divide
        m -= 1
    return m


_COUNTS = ("flops", "bytes", "peak_bytes", "arg_bytes", "temp_bytes",
           "output_bytes", "alias_bytes")
# microbatches traced, at most, of a training step: past it the step is
# traced at 2 and 3 and extrapolated (see ``lower_cell``)
_TRACED_MICROBATCHES = 3


def _trace(cfg: ArchConfig, shape: ShapeConfig, attn_chunk: int,
           remat: str, n_microbatch: int) -> Dict:
    """One trace of the cell's step on meta tensors (see ``lower_cell``)."""
    bundle = build_model(cfg, remat=remat, attn_chunk=attn_chunk)
    params = _meta_tree(bundle.decls)
    batch = _meta_tree(bundle.input_specs(shape))
    if shape.kind == "train":
        opt_cfg = OptConfig()
        step = make_train_step(bundle, opt_cfg, n_microbatch=n_microbatch)
        args = (params, init_opt_state(params, opt_cfg), batch)
    elif shape.kind == "prefill":
        step, args = bundle.prefill_fn, (params, batch)
    else:
        step = bundle.decode_fn
        args = (params, _meta_tree(bundle.cache_decls(shape)), batch)
    counter = StepCounter()
    arg_tensors = _tensors(args)
    t0 = time.perf_counter()
    with torch.inference_mode(shape.kind != "train"), \
            FlopCounterMode(display=False) as flops, counter:
        arg_bytes = counter.track(arg_tensors)
        out = step(*args)
    trace_s = time.perf_counter() - t0
    outs = _tensors(out)
    arg_keys = {counter.key(t) for t in arg_tensors}
    output_bytes = counter.storage_bytes(outs)
    alias_bytes = counter.storage_bytes(
        [t for t in outs if counter.key(t) in arg_keys])
    peak = counter.peak_bytes
    by_op = flops.get_flop_counts().get("Global", {})
    return {"flops": float(flops.get_total_flops()),
            "flops_by_op": {str(op): int(n) for op, n in by_op.items()},
            "bytes": float(counter.bytes), "peak_bytes": peak,
            "arg_bytes": arg_bytes,
            "temp_bytes": peak - arg_bytes - output_bytes + alias_bytes,
            "output_bytes": output_bytes, "alias_bytes": alias_bytes,
            "trace_s": trace_s}


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, *,
               attn_chunk: int = 1024, remat: str = "full",
               n_microbatch: Optional[int] = None) -> Dict:
    """Trace one cell's step on meta tensors.  Returns its counts:
    ``flops``, ``bytes``, ``peak_bytes``, ``arg_bytes``, ``output_bytes``,
    ``alias_bytes`` (outputs that reuse an argument's storage), and
    ``temp_bytes``, the rest of the peak (peak = arg + temp + output -
    alias, the reference's identity), and ``trace_s``; a single trace
    also ``flops_by_op`` (operator -> operations).

    A training step of m > 3 microbatches (``n_microbatch``, else
    ``microbatches``) is traced at 2 and 3 microbatches of the same size
    and every count extrapolated linearly in m: the loop's iterations are
    alike, the gradients accumulate into buffers the second one already
    holds, and only the batch grows with m, so the counts are m's."""
    m = n_microbatch or (microbatches(cfg, shape)
                         if shape.kind == "train" else 1)
    if shape.kind != "train" or m <= _TRACED_MICROBATCHES:
        return _trace(cfg, shape, attn_chunk, remat, m)
    micro = shape.global_batch // m
    c2, c3 = (_trace(cfg, replace(shape, global_batch=k * micro),
                     attn_chunk, remat, k) for k in (2, 3))
    out = {k: c2[k] + (m - 2) * (c3[k] - c2[k]) for k in _COUNTS}
    out["trace_s"] = c2["trace_s"] + c3["trace_s"]
    return out


_MEMORY_KEYS = ("arg_bytes", "temp_bytes", "output_bytes", "alias_bytes",
                "peak_bytes")


def run_cell(arch_name: str, shape_name: str, mesh_kind: str = "single",
             attn_chunk: int = 1024, remat: str = "full",
             skip_probes: bool = False, variant: str = "default",
             cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """One cell's record, in the reference's keys: the full-depth trace's
    memory (``full``), the roofline terms of the probes' extrapolated
    operations and bytes (of the full trace's with ``skip_probes``).
    ``cfg`` and ``shape`` stand in for the registry's (a configuration
    cut to size)."""
    if mesh_kind != "single":
        raise NotImplementedError(
            "the dry run covers one card (--mesh single); a mesh of more "
            "than one card is ROADMAP item 10")
    cfg = cfg or get_arch(arch_name)
    shape = shape or SHAPE_BY_NAME[shape_name]
    rec: Dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
                 "variant": variant}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update({"skipped": True, "reason": reason})
        return rec
    v = apply_variant(variant)
    kw = dict(attn_chunk=v.attn_chunk or attn_chunk, remat=v.remat or remat,
              n_microbatch=v.n_microbatch)

    # ---- 1. the full depth: the memory proof ------------------------------
    full = lower_cell(cfg, shape, **kw)
    peak = full["peak_bytes"]
    rec["full"] = {"trace_s": round(full["trace_s"], 2),
                   **{k: int(full[k]) for k in _MEMORY_KEYS},
                   "flops": full["flops"], "bytes": full["bytes"],
                   "fits_hbm": bool(peak <= HBM_PER_CHIP),
                   "collective_ops": {}}
    gc.collect()

    # ---- 2. cost probes at small depths, the layer stacks extrapolated ----
    cost = {k: full[k] for k in ("flops", "bytes")}
    if not skip_probes:
        plan = probe_plan(cfg)
        probe_costs = []
        for pcfg, _trips in plan.probes:
            c = lower_cell(pcfg, shape, **kw)
            probe_costs.append({k: c[k] for k in ("flops", "bytes")})
            gc.collect()
        cost = solve_extrapolation(plan, probe_costs)
        rec["probe_costs"] = probe_costs
    terms = RooflineTerms(
        flops_per_dev=cost["flops"] + analytic_extra_flops(cfg, shape, 1),
        bytes_per_dev=cost["bytes"], coll_bytes_per_dev=0.0, n_devices=1,
        model_flops_total=model_flops(cfg, shape))
    rec["roofline"] = terms.to_dict()
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    return rec


def cell_list():
    """Every (architecture, shape) of the registry, the recurrent stacks
    last."""
    def fam_rank(a):
        return {"ssm": 2, "hybrid": 2}.get(get_arch(a).family, 0)
    for a in sorted(ARCH_NAMES, key=fam_rank):
        for s in SHAPES:
            yield a, s.name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--variant", default="default")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(
            "the dry run covers one card (--mesh single); a mesh of more "
            "than one card is ROADMAP item 10")
    if args.all:
        cells = list(cell_list())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    tag = "" if args.variant == "default" else f"__{args.variant}"
    results = []
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape}__single{tag}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                prev = json.load(f)
            if "error" not in prev:        # errored cells are retried
                print(f"[skip] {arch} {shape} single")
                continue
        print(f"[cell] {arch} {shape} single ...", flush=True)
        t0 = time.perf_counter()
        try:
            rec = run_cell(arch, shape, "single", attn_chunk=args.attn_chunk,
                           remat=args.remat, skip_probes=args.skip_probes,
                           variant=args.variant)
        except Exception as e:  # noqa: BLE001 — record, continue the sweep
            rec = {"arch": arch, "shape": shape, "mesh": "single",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        rec["wall_s"] = round(time.perf_counter() - t0, 1)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = ("SKIP " + rec.get("reason", "")) if rec.get("skipped") \
            else ("ERROR " + rec.get("error", "")) if "error" in rec \
            else (f"ok fits={rec['full']['fits_hbm']} "
                  f"peak={rec['full']['peak_bytes'] / 2**30:.2f}GiB "
                  f"bottleneck={rec['roofline']['bottleneck']} "
                  f"mfu_bound={rec['roofline']['mfu_bound']:.3f}")
        print(f"       {status} ({rec['wall_s']}s)", flush=True)
        results.append(rec)
        gc.collect()
    print(f"done: {len(results)} cells")


if __name__ == "__main__":
    main()
