"""Batched serving engine: prefill + decode with KV and SSM caches.

``Engine.generate`` runs greedy decoding for a fixed budget; requests are
served in static batches (``serve_requests`` refills the slots from the
queue between bursts), as the JAX package's engine does.  ``generate``
hands the prefill the whole batch (an encoder-decoder's ``frames``, a
VLM's ``img``) and every decode step the batch's keys other than the
tokens; ``serve_requests`` passes tokens only, as the reference's does.
The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises where there is no card.  Everything runs under
``torch.inference_mode()``; the decode cache is updated in place (the
reference donates it), and the generated tokens stay on the device until
the burst ends.  Times are taken on the host's clock after
``torch.cuda.synchronize()`` on the card.  A bundle built on a mesh takes
parameters placed by ``models/param.py::shard_params``; its cache is held
one part a shard (``ShardedLeaf``), placed and joined by the bundle
(``ModelBundle.place_cache`` / ``join_cache``), and its logits come back
on the lead device.  Every family serves on such a mesh (models/lm.py):
the decoders (dense, MoE) and the hybrid tensor parallel under rules
that put heads over "model" (MEGATRON_FSDP), every family but the
decoders data parallel under rules that put the batch over "model" and
no heads there (SMALL_DP); the VLM, xLSTM and encoder-decoder under
heads over "model" raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.lm import ModelBundle
from repro_torch.models.param import tree_leaves, tree_map_with_path
from repro_torch.sharding.collectives import ShardedLeaf


def init_cache(bundle: ModelBundle, shape: ShapeConfig, device="cuda"):
    """An empty decode cache of ``shape`` on ``device``: zeros, slot
    tables -1, ``cur`` 0; placed as the bundle's prefill holds it
    (``ModelBundle.place_cache``) where the bundle runs on a mesh."""
    device = runtime.resolve_device(device)

    def mk(path, d):
        if d.dtype == torch.int32:
            fill = 0 if path[-1] == "cur" else -1
            return torch.full(d.shape, fill, dtype=torch.int32, device=device)
        return torch.zeros(d.shape, dtype=d.dtype, device=device)

    cache = tree_map_with_path(mk, bundle.cache_decls(shape))
    if bundle.sharded:
        cache = bundle.place_cache(cache)
    return cache


def _pad_axis(arr, axis: int, grow: int, fill):
    shape = list(arr.shape)
    shape[axis] += grow
    out = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    out.narrow(axis, 0, arr.shape[axis]).copy_(arr)
    return out


def grow_cache(cfg, cache, n_extra: int):
    """Extend KV-cache capacity after prefill so decoding does not
    ring-evict live context.  SWA caches stay capped at the window
    (eviction is then semantically correct).  Static cross-attention KV
    is never grown: its decode attends to every slot.  A cache placed on
    a mesh grows each shard's part."""
    if "slot_pos" not in cache:
        return cache                       # recurrent state: O(1), no growth
    cur_cap = cache["slot_pos"].shape[-1]
    window = cfg.attention.sliding_window
    target = cur_cap + n_extra
    if window:
        target = min(target, window)
    grow = target - cur_cap
    if grow <= 0:
        return cache

    def pad(path, arr):
        leaf = path[-1]
        if "cross_kv" in path:
            return arr
        if leaf in ("k", "v"):
            return _pad_axis(arr, arr.dim() - 3, grow, 0)
        if leaf in ("c", "krope"):           # MLA's latent cache
            return _pad_axis(arr, arr.dim() - 2, grow, 0)
        if leaf == "slot_pos":
            return _pad_axis(arr, arr.dim() - 1, grow, -1)
        return arr

    def visit(path, arr):
        if isinstance(arr, ShardedLeaf):
            return ShardedLeaf([pad(path, p) for p in arr.parts], arr.spec,
                               arr.mesh)
        return pad(path, arr)

    return tree_map_with_path(visit, cache)


@dataclass
class GenResult:
    tokens: np.ndarray          # (B, n_gen)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class Engine:
    def __init__(self, bundle: ModelBundle, params, device="cuda"):
        self.bundle = bundle
        self.params = params
        self.device = runtime.resolve_device(device)
        first = tree_leaves(params)
        if first and first[0].device != self.device:
            raise ValueError(f"params lie on {first[0].device}, the engine "
                             f"runs on {self.device}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_device(self, value):
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.asarray(value), device=self.device)

    @torch.inference_mode()
    def generate(self, batch: Dict, n_gen: int = 16) -> GenResult:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int32, device=self.device)
        extra = {k: self._on_device(v) for k, v in batch.items()
                 if k not in ("tokens", "targets")}
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.bundle.prefill_fn(self.params,
                                               {"tokens": tokens, **extra})
        cache = grow_cache(self.bundle.arch, cache, n_gen)
        next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        out = [next_tok]
        for _ in range(n_gen - 1):
            logits, cache = self.bundle.decode_fn(
                self.params, cache, {"tokens": next_tok, **extra})
            next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(next_tok)
        self._sync()
        t2 = time.perf_counter()
        toks = torch.cat(out, dim=1).cpu().numpy()
        bsz = toks.shape[0]
        return GenResult(tokens=toks, prefill_s=t1 - t0, decode_s=t2 - t1,
                         tokens_per_s=bsz * (n_gen - 1) / max(t2 - t1, 1e-9))

    def serve_requests(self, prompts: List[np.ndarray], batch_size: int,
                       prompt_len: int, n_gen: int = 8) -> List[np.ndarray]:
        """Slot-based continuous batching: pad prompts into fixed slots
        (left-padded with token 0), refill slots from the queue between
        bursts."""
        results: List[Optional[np.ndarray]] = [None] * len(prompts)
        queue = list(range(len(prompts)))
        self.last_results: List[GenResult] = []
        while queue:
            slots = queue[:batch_size]
            queue = queue[batch_size:]
            toks = np.zeros((batch_size, prompt_len), np.int32)
            for i, ridx in enumerate(slots):
                p = prompts[ridx][-prompt_len:]
                toks[i, -len(p):] = p
            res = self.generate({"tokens": toks}, n_gen=n_gen)
            self.last_results.append(res)
            for i, ridx in enumerate(slots):
                results[ridx] = res.tokens[i]
        return results  # type: ignore
