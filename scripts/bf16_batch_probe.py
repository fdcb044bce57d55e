"""Where a bf16 prefill on the card depends on the batch's size.

xlstm-350m at full width cut to ``--blocks`` blocks (7 mLSTM blocks and an
sLSTM block at 8), bf16 weights drawn on the card from a seed, prefilled
twice: on one row alone, and on the same row as row 0 of a ``--rows``-row
batch.  Every aten operation's output, and each K6 launch's, is recorded
in both runs (row 0 of the batch run: the first n entries of the dim that
holds the batch), and the two runs are compared operation by operation:
the first operation whose output differs while every input it read was
equal is the one that rounds by the batch's size.  Also compared: each
block's output, and the last position's logits (as a share of
max|logits|, the measure serve_tp reports).

    python3 scripts/bf16_batch_probe.py [--blocks 8] [--rows 4] [--seq 2048]
        [--out chiprun_out/bf16_batch_probe.json]

Needs a CUDA device; exits non-zero without one.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, init_tree  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SEED = 20241115
# operations left out of the comparison: fresh allocations (no defined
# value) and data movement, which cannot round and which one run may make
# where the other needs none (a reshape that is a view at one row and a
# copy at four); views are left out by their output too
SKIP = {"aten.empty.memory_format", "aten.empty_strided.default",
        "aten.empty_like.default", "aten.new_empty.default",
        "aten.new_empty_strided.default", "aten.clone.default",
        "aten.copy_.default", "aten._unsafe_view.default",
        "aten.contiguous.default", "aten.lift_fresh.default",
        "aten.detach.default", "aten.alias.default"} | {
            f"aten.{op}" for op in (
                "reshape.default", "view.default", "narrow.default",
                "permute.default", "movedim.int", "unsqueeze.default",
                "squeeze.dim", "select.int", "slice.Tensor",
                "expand.default", "transpose.int", "t.default",
                "unflatten.int", "flatten.using_ints", "chunk.default",
                "split.Tensor", "unbind.int")}
GEMMS = ("aten.matmul.default", "aten.mm.default", "aten.bmm.default",
         "aten.addmm.default", "aten.einsum.default")


def _row0(t: torch.Tensor, n_one: torch.Size):
    """The part of a batch run's output that the one-row run computed:
    the output itself where the shapes agree, else the first entries of
    the one dim whose size differs (None where no such dim lines up)."""
    if t.shape == n_one:
        return t
    if t.dim() != len(n_one):
        return None
    diff = [d for d in range(t.dim()) if t.shape[d] != n_one[d]]
    if len(diff) != 1 or t.shape[diff[0]] < n_one[diff[0]]:
        return None
    return t.narrow(diff[0], 0, n_one[diff[0]])


class Recorder(TorchDispatchMode):
    """Every floating output of every aten op, in call order: (op name,
    block label, output shapes, the outputs themselves)."""

    def __init__(self, probe):
        super().__init__()
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if name not in SKIP:
            flat, _ = tree_flatten(out)
            ins = {id(a) for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)}
            # an output that is an input (a conversion to its own type)
            # computes nothing: one run may call it where the other does
            # not
            self.probe.record(name, [t for t in flat
                                     if isinstance(t, torch.Tensor)
                                     and t._base is None
                                     and id(t) not in ins], func, args)
        return out


class Probe:
    def __init__(self):
        self.ref = None          # the one-row run's records
        self.events = []
        self.block = "embed"
        self.diffs = []
        self.blocks = {}
        self.lost = None
        self.gemms = {}

    def gemm_check(self, name, func, args):
        """The first differing product again, alone: on row 0's input by
        itself, and on that row repeated as many times as the batch has
        rows (the same data, a product of M times as many rows)."""
        x, rest = args[0], args[1:]
        rows = x.shape[0]
        alone = func(x[:1], *rest)
        repeated = func(x[:1].expand(rows, *x.shape[1:]).contiguous(),
                        *rest)
        self.gemms = {
            "op": name, "input_shapes": [list(a.shape) for a in args
                                         if isinstance(a, torch.Tensor)],
            "dtypes": [str(a.dtype) for a in args
                       if isinstance(a, torch.Tensor)],
            "same_row_repeated_max_abs_diff": float(
                (repeated.float() - alone.float()).abs().max()
                .item()) if repeated.dim() == alone.dim() else None,
            "rows_of_repeated_differ_from_each_other": bool(
                (repeated.float() - repeated[:1].float()).abs().max()
                .item() > 0)}

    def record(self, name, outs, func=None, args=()):
        outs = [t for t in outs if t.is_floating_point()]
        if not outs:
            return
        i = len(self.events)
        if self.ref is None:
            self.events.append((name, self.block, [o.shape for o in outs],
                                [o.detach().clone() for o in outs]))
            return
        self.events.append(name)
        if i >= len(self.ref):
            return
        if self.lost:
            return
        rname, rblock, rshapes, routs = self.ref[i]
        if rname != name or len(rshapes) != len(outs):
            # the two runs' sequences part: nothing after compares
            self.lost = {"index": i, "op": name, "block": self.block,
                         "one_row_op": rname,
                         "one_row_before": [e[0] for e in
                                            self.ref[max(i - 3, 0):i + 3]]}
            return
        worst = 0.0
        scale = 0.0
        lined = True
        for o, rs, r in zip(outs, rshapes, routs):
            part = _row0(o, rs)
            if part is None:
                lined = False
                continue
            d = (part.float() - r.float()).abs().max().item()
            worst = max(worst, d)
            scale = max(scale, r.float().abs().max().item())
        if worst > 0 and name in GEMMS and not self.gemms:
            self.gemm_check(name, func, args)
        if worst > 0 or not lined:
            self.diffs.append({"index": i, "op": name, "block": self.block,
                               "one_row_shapes": [list(s) for s in rshapes],
                               "batch_shapes": [list(o.shape) for o in outs],
                               "max_abs_diff": worst, "max_abs": scale,
                               "aligned": lined})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--out", default="chiprun_out/bf16_batch_probe.json")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the probe's control flow")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this probe measures the card", file=sys.stderr)
        return 1
    card = "cpu" if device.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cfg = dataclasses.replace(get_arch("xlstm-350m"), n_layers=args.blocks)
    bundle = build_model(cfg)
    params = init_tree(bundle.decls,
                       torch.Generator(device=device).manual_seed(SEED),
                       device)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (args.rows, args.seq)).astype(np.int32),
        device=device)
    probe = Probe()
    real = {"mlstm_forward": ssm.mlstm_forward,
            "slstm_forward": ssm.slstm_forward, "ssd_scan": ops.ssd_scan}
    count = {"n": 0}

    def labelled(key):
        fn = real[key]

        def run(*a, **kw):
            probe.block = f"{key[:5]}[{count['n']}]"
            out = fn(*a, **kw)
            h = out[0] if isinstance(out, tuple) else out
            probe.blocks.setdefault(probe.block, []).append(
                h.detach().clone())
            count["n"] += 1
            return out
        return run

    def k6(*a, **kw):
        out = real["ssd_scan"](*a, **kw)
        probe.record("K6 ssd_scan (csrc/lm.cu)", list(out))
        return out

    ssm.mlstm_forward = labelled("mlstm_forward")
    ssm.slstm_forward = labelled("slstm_forward")
    ops.ssd_scan = k6
    logits = []
    t0 = time.perf_counter()
    try:
        for rows in (1, args.rows):
            count["n"] = 0
            probe.block = "embed"
            with torch.inference_mode(), Recorder(probe):
                out, _ = bundle.prefill_fn(params, {"tokens": tokens[:rows]})
            if device.type == "cuda":
                torch.cuda.synchronize()
            logits.append(out.float())
            if probe.ref is None:
                probe.ref, probe.events = probe.events, []
    finally:
        ssm.mlstm_forward = real["mlstm_forward"]
        ssm.slstm_forward = real["slstm_forward"]
        ops.ssd_scan = real["ssd_scan"]
    blocks = {}
    for name, hs in probe.blocks.items():
        one, batch = hs[0], hs[1][:1]
        blocks[name] = float((batch.float() - one.float()).abs().max()
                             / one.float().abs().max())
    one, batch = logits[0], logits[1][:1]
    first = next((d for d in probe.diffs), None)
    result = {
        "card": card, "arch": cfg.name, "blocks": args.blocks,
        "rows": args.rows, "seq": args.seq, "dtype": "bf16",
        "ops_one_row": len(probe.ref), "ops_batch": len(probe.events),
        "logits_row0_rel": float((batch - one).abs().max()
                                 / one.abs().max()),
        "block_out_row0_rel": blocks,
        "first_differing_op": first,
        "differing_ops": len(probe.diffs),
        "sequences_part": probe.lost,
        "first_product_alone": probe.gemms,
        "first_20": probe.diffs[:20],
        "seconds": time.perf_counter() - t0,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "first_20"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
