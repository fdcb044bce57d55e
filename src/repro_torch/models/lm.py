"""Model assembly of the port: an architecture becomes a ModelBundle with

* ``decls``                             — PDecl tree (params)
* ``loss_fn(params, batch)``            -> (loss, metrics)
* ``prefill_fn(params, batch)``         -> (logits_last, cache)
* ``decode_fn(params, cache, batch)``   -> (logits, cache)
* ``cache_decls(shape)``                — PDecl tree of the decode cache
* ``input_specs(shape)``                — PDecl tree of the inputs

Ported, for serving, every family of the reference: the decoder-only
builder with dense (GQA, sliding window, QKV bias), MoE (routed and
shared experts, with deepseek's leading dense layers) and MLA
(deepseek-v2-lite's latent attention); the hybrid (zamba2); the xLSTM
(groups of mLSTM blocks and one sLSTM block); the encoder-decoder
(whisper: a non-causal encoder over precomputed frames, a decoder with
self- and cross-attention); and the VLM (a decoder with a gated
cross-attention layer every ``cross_attn_every`` layers, against
precomputed image patches).  Stacked layers run as Python loops over the
stacked leading axes (the port has no scan), on whichever device the
parameters lie: on the card the prefill's attention and SSD scans go
through the hand-written kernels (see ``layers`` and ``ssm``).
``decode_fn`` updates the cache it is given in place, where the reference
donates it.  The frames and image patches are cast to their projection's
type (the input specs declare them in it).

On a mesh (launch/mesh.py) with an axis of more than one shard,
``build_model(cfg, rules, mesh)`` declares the reference's trees there,
its parameters placed by ``models/param.py::shard_params``, and every
family serves sharded by the rules (``_on_mesh``):

* the decoder family (dense, MoE), whatever the rules, and the hybrid and
  the VLM under rules that put heads over "model" (MEGATRON_FSDP,
  zamba2-7b's and llama-3.2-vision-90b's), tensor parallel
  (``_decoder_on_mesh``, ``_hybrid_on_mesh``, ``_vlm_on_mesh``): the batch
  rows, the decode cache and the positions over "data"; attention heads,
  MLP width, the Mamba-2 blocks' SSM heads (models/ssm.py's stages) and
  the vocabulary over "model" (models/layers.py's stages; the
  vocab-parallel lookup and the logits gathered over "model"); every
  leaf the rules put over "data" (FSDP) gathered before its stage uses
  it; the MoE layers' routed experts expert parallel over "model"
  (models/moe.py); the VLM's cross-attention layers project the image's
  keys and values on each shard for its KV heads, the gate applied after
  the sum over "model".  Each (data, model) shard holds the keys and
  values of its batch rows and of the KV heads its query heads use (MLA:
  the latent of its batch rows; the VLM's cross keys and values alike),
  where the reference declares the cache over "kv_seq" (the VLM's cross
  cache by batch rows alone), and the hybrid's SSM states of its SSM
  heads and conv window of its x channels with bm and cm (the values are
  the same); the residual between blocks is whole on every model shard,
  where the reference constrains it to "seq_shard";
* every other family (hybrid, xLSTM, encoder-decoder, VLM) under rules
  that put the batch over "model" and no heads there (SMALL_DP,
  xlstm-350m's and whisper-base's), data parallel over every axis the
  rules give the batch (``_data_parallel``): the parameters gathered
  whole, the family's one-device prefill and decode on each shard's
  rows, the cache held by batch rows.

The bundle places and joins its decode cache (``ModelBundle.place_cache``,
``join_cache``).  The xLSTM and encoder-decoder under rules that put
heads over "model" raise ``NotImplementedError``.  On a mesh the dense
decoders train (``_decoder_on_mesh``'s ``loss_fn``: the prefill's stages
under autograd, the collectives' backwards their adjoints); the MoE
decoder, the hybrid, the VLM and the data-parallel form raise in
``loss_fn`` (ROADMAP Queue 1 item 1).

Training: ``loss_fn`` composes the loss as the reference does — the mean
cross-entropy of ``chunked_ce_loss`` (plus the MoE aux term for the
decoder, ``{"ce", "aux"}`` beside it) — and autograd gives its gradient.
Each builder's ``remat`` ("none", "full", "dots") wraps the layer bodies
the reference wraps (``_remat``); it acts only under grad mode, so the
serve path runs exactly as before.  On the card attention's backward is
K5's hand-written kernel and the SSD scan's is K6's (``csrc/ssd_bwd.cu``
through ``SsdScanFunction``), so every family trains on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    attn_decls, attn_decode, attn_decode_stage, attn_forward, attn_stage,
    mlp_decls, mlp_forward, mlp_stage, replicated, rms_norm, shard_heads,
    sinusoidal_pos, tp_heads,
)
from repro_torch.models.moe import moe_decls, moe_forward
from repro_torch.models.param import (
    PDecl, tree_map, tree_map_with_path, tree_paths,
)
from repro_torch.sharding.axes import MEGATRON_FSDP, SMALL_DP, rules_for
from repro_torch.sharding.collectives import (
    ShardedLeaf, join_spec, mesh_gather, mesh_sum, on_shard, respec,
    split_spec,
)

F32 = torch.float32
I32 = torch.int32


def stack_decls(tree, n: int):
    return tree_map(
        lambda p: PDecl((n,) + p.shape, ("layers",) + p.logical,
                        p.dtype, p.init, p.scale), tree)


# the products whose outputs "dots" keeps for the backward (the
# counterpart of jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under the reference's rematerialisation ``mode``: "none"
    keeps every activation, "full" keeps only the inputs and recomputes
    the body in the backward (``torch.utils.checkpoint``), "dots" keeps
    the matrix products' outputs and recomputes the rest.  Outside grad
    mode the body runs as it is."""
    if mode == "none":
        return fn
    kw = {"full": {}, "dots": {"context_fn": partial(
        create_selective_checkpoint_contexts, _dots_policy)}}[mode]

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _index(tree, *idx):
    """One layer's parameters (views) out of a stacked tree."""
    return {k: (_index(v, *idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


@dataclass
class ModelBundle:
    arch: ArchConfig
    decls: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    cache_decls: Callable          # (ShapeConfig) -> PDecl tree
    input_specs: Callable          # (ShapeConfig) -> dict of PDecl
    mesh: Any = None               # the mesh the bundle runs sharded on
    # on such a mesh: a whole (one-device) decode cache placed as the
    # bundle's prefill holds it, and a placed cache joined back into the
    # one-device layout on the lead device
    place_cache: Optional[Callable] = None
    join_cache: Optional[Callable] = None
    rules: Any = None              # the logical-axis rules it was built by

    @property
    def sharded(self) -> bool:
        """Whether the bundle runs on a mesh with an axis of more than one
        shard."""
        return _sharded(self.mesh)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _emb_decls(cfg: ArchConfig) -> Dict[str, PDecl]:
    d = {"emb": PDecl((cfg.vocab_size, cfg.d_model), ("vocab", "embed_tp"))}
    if not cfg.tie_embeddings:
        d["unemb"] = PDecl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    d["lnf"] = PDecl((cfg.d_model,), (None,), init="ones")
    return d


def _unemb(params, cfg):
    return params["emb"].T if cfg.tie_embeddings else params["unemb"]


def _embed(params, tokens):
    # a gather whose backward sums into rows in a fixed order (indexing's
    # backward is an accumulating scatter, whose order on the card is not)
    return F.embedding(tokens.long(), params["emb"])


def chunked_ce_loss(unemb, h, targets, chunk: int = 512):
    """Mean cross-entropy over (B, S), the logits formed a sequence chunk
    at a time in float32 and summed per chunk, then across chunks, as the
    reference does.  Under grad mode each chunk is checkpointed, so only
    one chunk's (B, chunk, V) float32 logits live at once in the backward
    too.  S must be a multiple of ``min(chunk, S)`` (the reference's
    reshape refuses it otherwise)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")

    def body(hc, tc):
        logits = (hc @ unemb).to(F32)
        lse = torch.logsumexp(logits, dim=-1)
        # gather's backward adds one value into each row's target slot
        # (no two into one place), so its order on the card is immaterial
        gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
        return torch.sum(lse - gold)

    body = _remat(body, "full")
    tot = torch.zeros((), dtype=F32, device=h.device)
    for c0 in range(0, s, chunk):
        tot = tot + body(h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk])
    return tot / (b * s)


def _last_logits(unemb, h):
    return (h[:, -1] @ unemb).to(F32)


def _kv_cache_decls(cfg: ArchConfig, n_layers: int, batch: int, s_max: int,
                    prefix: Tuple[int, ...] = ()):
    a = cfg.attention
    cap = min(s_max, a.sliding_window) if a.sliding_window else s_max
    lead = prefix + (n_layers,) if n_layers else prefix
    lax_names = tuple(None for _ in lead)
    if a.is_mla:
        return {
            "c": PDecl(lead + (batch, cap, a.kv_lora_rank),
                       lax_names + ("batch", "kv_seq", None)),
            "krope": PDecl(lead + (batch, cap, a.rope_head_dim),
                           lax_names + ("batch", "kv_seq", None)),
        }, cap
    return {
        "k": PDecl(lead + (batch, cap, a.n_kv_heads, a.head_dim),
                   lax_names + ("batch", "kv_seq", None, None)),
        "v": PDecl(lead + (batch, cap, a.n_kv_heads, a.head_dim),
                   lax_names + ("batch", "kv_seq", None, None)),
    }, cap


def _pos_decls(batch: int, cap: int):
    return {
        "slot_pos": PDecl((batch, cap), ("batch", "kv_seq"),
                          dtype=I32, init="zeros"),
        "cur": PDecl((batch,), ("batch",), dtype=I32, init="zeros"),
    }


def _advance_pos(cache, cap: int):
    """Update the shared slot->position table for this step (in place)."""
    cur = cache["cur"]
    slot = (cur % cap).long()
    bidx = torch.arange(cur.shape[0], device=cur.device)
    slot_pos = cache["slot_pos"]
    slot_pos[bidx, slot] = cur
    return cur, slot_pos


def _dense_layer_decls(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": PDecl((cfg.d_model,), (None,), init="ones"),
        "attn": attn_decls(cfg.attention, cfg.d_model),
        "ln2": PDecl((cfg.d_model,), (None,), init="ones"),
        "mlp": mlp_decls(cfg.d_model, cfg.d_ff, cfg.glu),
    }


def _moe_layer_decls(cfg: ArchConfig, ep: int) -> Dict[str, Any]:
    return {
        "ln1": PDecl((cfg.d_model,), (None,), init="ones"),
        "attn": attn_decls(cfg.attention, cfg.d_model),
        "ln2": PDecl((cfg.d_model,), (None,), init="ones"),
        "moe": moe_decls(cfg, ep),
    }


def _mlp_block(cfg: ArchConfig, lp, h):
    """h plus the layer's MLP of its ``ln2``-normed residual."""
    return h + mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                           cfg.act, cfg.glu)


def _stacked(xs, *lead):
    """Per-layer tensors stacked under the leading axes ``lead``."""
    return torch.stack(xs).reshape(*lead, *xs[0].shape)


def _prefill_positions(b: int, s: int, device, cap: Optional[int] = None):
    """A prefill's slot table and ``cur``: slot i holds position i, or,
    where the cache keeps only the last ``cap`` positions, position s - cap
    + i."""
    cap = s if cap is None else cap
    return (torch.arange(s - cap, s, dtype=I32, device=device).repeat(b, 1),
            torch.full((b,), s, dtype=I32, device=device))


def _token_specs(shape: ShapeConfig):
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    return {"tokens": PDecl((b, s), ("batch", None), dtype=I32)}


def _train_specs(specs_fn):
    """``specs_fn`` plus the targets of a training shape, as the
    reference's input specs declare them."""
    def specs(shape: ShapeConfig):
        out = specs_fn(shape)
        if shape.kind == "train":
            out["targets"] = PDecl((shape.global_batch, shape.seq_len),
                                   ("batch", None), dtype=I32)
        return out
    return specs


# ---------------------------------------------------------------------------
# decoder-only: the dense and MoE families (GQA, SWA, QKV bias, MLA)
# ---------------------------------------------------------------------------
def build_decoder(cfg: ArchConfig, rules=None, mesh=None,
                  remat: str = "full", attn_chunk: int = 1024,
                  ep_axis: str = "model") -> ModelBundle:
    """The reference's ``build_decoder``: ``layers`` stacked n_layers -
    first_dense_layers deep, deepseek's leading dense layers stacked under
    ``head_layers``.  On a ``mesh`` (launch/mesh.py) with an axis of more
    than one shard it serves sharded (``_decoder_on_mesh``), the routed
    experts declared padded to a multiple of ``ep_axis``'s size."""
    is_moe = cfg.family == "moe"
    ep = mesh.shape[ep_axis] if (is_moe and mesh is not None) else 1
    n_dense_head = cfg.moe.first_dense_layers if is_moe else 0
    n_scan = cfg.n_layers - n_dense_head
    mla = cfg.attention.is_mla

    decls = _emb_decls(cfg)
    if is_moe:
        decls["layers"] = stack_decls(_moe_layer_decls(cfg, ep), n_scan)
        if n_dense_head:
            head = {
                "ln1": PDecl((cfg.d_model,), (None,), init="ones"),
                "attn": attn_decls(cfg.attention, cfg.d_model),
                "ln2": PDecl((cfg.d_model,), (None,), init="ones"),
                "mlp": mlp_decls(cfg.d_model, cfg.moe.d_first_dense, cfg.glu),
            }
            decls["head_layers"] = stack_decls(head, n_dense_head)
    else:
        decls["layers"] = stack_decls(_dense_layer_decls(cfg), n_scan)

    def ffn(lp, h):
        """The layer's MLP or MoE on the normed residual: (out, aux)."""
        x = rms_norm(h, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            return moe_forward(lp["moe"], cfg, x, mesh=mesh,
                               ep_axis=ep_axis)
        return mlp_forward(lp["mlp"], x, cfg.act, cfg.glu), None

    def layer(lp, h):                 # queries at arange(S): positions None
        a, kv = attn_forward(lp["attn"], cfg.attention,
                             rms_norm(h, lp["ln1"], cfg.norm_eps),
                             chunk=attn_chunk)
        h = h + a
        m, aux = ffn(lp, h)
        return h + m, kv, aux

    def train_layer(lp, h):
        h, _, aux = layer(lp, h)
        return h, aux

    train_layer = _remat(train_layer, remat)

    # (stacked params and cache key, depth) in the order they run
    stacks = ([("head_layers", n_dense_head)] if n_dense_head else []) \
        + [("layers", n_scan)]

    def backbone(params, tokens, collect: bool = True):
        """(h, the MoE aux loss, {stack: its layers' cache pairs, stacked}
        when ``collect``; else the training form: layers under remat, no
        cache)."""
        h = _embed(params, tokens)
        aux_total = torch.zeros((), dtype=F32, device=h.device)
        kvs = {}
        for name, depth in stacks:
            got = []
            for i in range(depth):
                lp = _index(params[name], i)
                if collect:
                    h, kv, aux = layer(lp, h)
                    got.append(kv)
                else:
                    h, aux = train_layer(lp, h)
                if aux is not None:
                    aux_total = aux_total + aux
            if collect:
                kvs[name] = tuple(torch.stack(t) for t in zip(*got))
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        return h, aux_total, kvs

    def loss_fn(params, batch):
        h, aux, _ = backbone(params, batch["tokens"], collect=False)
        ce = chunked_ce_loss(_unemb(params, cfg), h, batch["targets"])
        return ce + aux, {"ce": ce, "aux": aux}

    def cache_decls(shape: ShapeConfig):
        kv, cap = _kv_cache_decls(cfg, n_scan, shape.global_batch,
                                  shape.seq_len)
        out = {"layers": kv}
        if n_dense_head:
            hkv, _ = _kv_cache_decls(cfg, n_dense_head, shape.global_batch,
                                     shape.seq_len)
            out["head_layers"] = hkv
        out.update(_pos_decls(shape.global_batch, cap))
        return out

    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        h, _, kvs = backbone(params, tokens)
        logits = _last_logits(_unemb(params, cfg), h)
        names = ("c", "krope") if mla else ("k", "v")
        cache = {name: dict(zip(names, kv)) for name, kv in kvs.items()}
        cache["slot_pos"], cache["cur"] = _prefill_positions(b, s,
                                                             tokens.device)
        return logits, cache

    def decode_fn(params, cache, batch):
        cap = cache["slot_pos"].shape[1]
        cur, slot_pos = _advance_pos(cache, cap)
        h = _embed(params, batch["tokens"])
        for name, depth in stacks:
            lc = cache[name]
            for i in range(depth):
                lp = _index(params[name], i)
                a, _ = attn_decode(lp["attn"], cfg.attention,
                                   rms_norm(h, lp["ln1"], cfg.norm_eps),
                                   cur, slot_pos, _index(lc, i))
                h = h + a
                h = h + ffn(lp, h)[0]
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["slot_pos"] = slot_pos
        out["cur"] = cur + 1
        return logits, out

    if _sharded(mesh):
        loss_fn, prefill_fn, decode_fn = _decoder_on_mesh(
            cfg, mesh, stacks, attn_chunk, ep_axis, remat)
    return ModelBundle(cfg, decls, loss_fn, prefill_fn, decode_fn,
                       cache_decls, _train_specs(_token_specs), mesh,
                       place_cache=lambda c: place_cache(cfg, c, mesh),
                       join_cache=partial(join_cache, cfg))


# ---------------------------------------------------------------------------
# the decoder on a mesh: tensor parallel over "model", FSDP and the batch
# over "data"
# ---------------------------------------------------------------------------
def _sharded(mesh) -> bool:
    """A mesh with an axis of more than one shard."""
    return mesh is not None and any(n > 1 for n in mesh.dims)


def _rule_axes(rules, name: str) -> Tuple[str, ...]:
    """The mesh axes ``rules`` give the logical axis ``name``."""
    entry = rules.to_dict().get(name)
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def _rules_name(rules) -> str:
    for name, table in (("MEGATRON_FSDP", MEGATRON_FSDP),
                        ("SMALL_DP", SMALL_DP)):
        if rules == table:
            return name
    return (f"rules putting heads on {_rule_axes(rules, 'heads')} and the "
            f"batch on {_rule_axes(rules, 'batch')}")


def _no_training(cfg: ArchConfig):
    def refuse(*_):
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) on a mesh is not ported "
            "(ROADMAP Queue 1 item 1)")
    return refuse


def _on_mesh(bundle: ModelBundle, rules, mesh,
             tensor_parallel: Optional[Callable] = None) -> ModelBundle:
    """``bundle`` recording ``mesh``, and on a mesh with an axis of more
    than one shard its sharded form by the rules: ``tensor_parallel``
    (the hybrid's) where they put heads over "model"; the data-parallel
    form (``_data_parallel``) where they put the batch over "model" and
    no heads there (SMALL_DP).  Any other pair keeps the reference's
    trees, and its loss, prefill, decode and cache placement raise
    ``NotImplementedError`` naming the family and the rules (they must
    not run unsharded beside placed leaves)."""
    if not _sharded(mesh):
        return replace(bundle, mesh=mesh)
    cfg = bundle.arch
    if rules is None:
        rules = rules_for(cfg.name, "train", cfg.d_model)
    heads = "model" in _rule_axes(rules, "heads")
    if heads and tensor_parallel is not None:
        return tensor_parallel(bundle)
    if not heads and "model" in _rule_axes(rules, "batch"):
        return _data_parallel(bundle, rules, mesh)

    def refuse(*_):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) under {_rules_name(rules)} on a mesh "
            f"of {dict(mesh.shape)}: not ported (ROADMAP Queue 1 item 1)")
    return replace(bundle, loss_fn=refuse, prefill_fn=refuse,
                   decode_fn=refuse, place_cache=refuse, join_cache=refuse,
                   mesh=mesh)


def _check_tp(cfg: ArchConfig, tp: int) -> None:
    """Every width the model axis splits divides its degree; else
    ``ValueError`` (a prefill or decode step checks before its first
    launch)."""
    tp_heads(cfg.attention, tp)
    if cfg.family == "hybrid":
        S.tp_ssm_heads(cfg, tp)
    widths = {"vocabulary": cfg.vocab_size}
    if cfg.family == "moe":
        m = cfg.moe
        widths.update({"dense head MLP": m.d_first_dense
                       if m.first_dense_layers else 0,
                       "shared expert": m.d_shared})
    else:
        widths["MLP"] = cfg.d_ff
    for what, n in widths.items():
        if n % tp:
            raise ValueError(f"{cfg.name}: the {what} width {n} does not "
                             f"split over a model degree of {tp}")


def _batch_spec(b: int, mesh):
    """The batch rows over "data" where they divide it; else every data
    shard holds them all (as models/moe.py degrades)."""
    return "data" if b % mesh.shape.get("data", 1) == 0 else None


def _kv_spec(name: str, bspec, lead: int = 1):
    """The spec of a placed cache leaf: keys and values by batch rows and
    KV heads, MLA's latent by batch rows (the same on every model shard),
    under ``lead`` stacked dims.  Where a shard's KV head is shared with
    other model shards (the KV heads fewer than the degree), each holds
    its own copy, so the joined head dim repeats each KV head."""
    if name in ("k", "v"):
        return (None,) * lead + (bspec, None, "model", None)
    return (None,) * lead + (bspec, None, None)


def _each(mesh, fn, *lists):
    """``fn`` on every shard's items of ``lists``, each on its device."""
    out = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            out.append(fn(*(items[i] for items in lists)))
    return out


def _normed(hs, w, mesh, eps: float):
    """Each shard's activations RMS-normed by ``w`` (whole on every
    shard)."""
    return _each(mesh, lambda h, g: rms_norm(h, g, eps), hs,
                 replicated(w, mesh))


def _embed_stage(emb, toks, mesh):
    """The vocab-parallel lookup: each shard looks up the tokens that fall
    in its vocab block (zeros for the rest), summed over "model": one
    nonzero term a row, so exactly the one-device lookup."""
    blocks = respec(emb, ("model", None), mesh)

    def look(i, tok, block):
        n = block.shape[0]
        ids = tok.long() - mesh.axis_index(i, "model") * n
        hit = (ids >= 0) & (ids < n)
        e = F.embedding(ids.clamp(0, n - 1), block)
        return torch.where(hit[..., None], e, torch.zeros_like(e))
    return mesh_sum(_each(mesh, look, range(len(mesh.devices)), toks,
                          blocks), mesh, axis="model")


def _logits_stage(params, cfg: ArchConfig, hs, mesh, bspec):
    """Each shard's vocab block of the last position's logits, gathered
    over "model", the batch joined over "data" on the lead device."""
    if cfg.tie_embeddings:
        blocks = [b.T for b in respec(params["emb"], ("model", None), mesh)]
    else:
        blocks = respec(params["unemb"], (None, "model"), mesh)
    parts = _each(mesh, lambda h, u: (h[:, -1] @ u).to(F32), hs, blocks)
    return join_spec(mesh_gather(parts, -1, mesh, axis="model"),
                     (bspec, None), mesh)


def _mlp_half(cfg: ArchConfig, lp, hs, mesh):
    """Each shard's residual plus the layer's MLP of its ``ln2``-normed
    residual, the MLP over "model" (``mlp_stage``)."""
    ys = mlp_stage(lp["mlp"], _normed(hs, lp["ln2"], mesh, cfg.norm_eps),
                   mesh, cfg.act, cfg.glu)
    return _each(mesh, torch.add, hs, ys)


def _mesh_ce_loss(params, cfg: ArchConfig, hs, tgts, mesh, bspec,
                  n_rows: int, chunk: int = 512):
    """``chunked_ce_loss`` on a mesh: each shard's rows (whole over
    "model") cut into chunks of ``chunk`` positions; a chunk's logits are
    formed on each shard for its vocab block in float32 and gathered over
    "model" (one chunk holds rows x chunk x vocab float32 logits a shard:
    65.5 MB a row at h2o-danube-3-4b's 32000), each row's log-sum-exp
    less its target's logit summed per chunk on each shard, the sums of
    the shards at place 0 of "model" added over "data" (``join_spec``),
    then across chunks; the mean over ``n_rows`` x the positions.  Each
    chunk is checkpointed under grad mode, as the one-device loss's."""
    if cfg.tie_embeddings:
        blocks = [b.T for b in respec(params["emb"], ("model", None), mesh)]
    else:
        blocks = respec(params["unemb"], (None, "model"), mesh)
    s = hs[0].shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")

    def nll(logits, t):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return torch.sum(lse - gold)[None]

    def body(hcs, tcs, us):
        parts = _each(mesh, lambda h, u: (h @ u).to(F32), hcs, us)
        logits = mesh_gather(parts, -1, mesh, axis="model")
        return join_spec(_each(mesh, nll, logits, tcs), (bspec,),
                         mesh).sum()

    body = _remat(body, "full")
    tot = torch.zeros((), dtype=F32, device=mesh.device)
    for c0 in range(0, s, chunk):
        tot = tot + body([h[:, c0:c0 + chunk] for h in hs],
                         [t[:, c0:c0 + chunk] for t in tgts], blocks)
    return tot / (n_rows * s)


def _decoder_on_mesh(cfg: ArchConfig, mesh, stacks, attn_chunk: int,
                     ep_axis: str, remat: str):
    """(loss_fn, prefill_fn, decode_fn) of the decoder on ``mesh``.  The
    activations are one tensor per shard (the batch rows of its data
    place, whole over "model"), and every block is a stage run on each
    shard in shard order between collectives: the embedding's sum, each
    attention's and MLP's sum over "model", the logits' gather, the
    gathers of FSDP-placed leaves; a MoE layer's tokens are joined over
    "data" for the expert-parallel paths and split again after.

    ``loss_fn`` (the dense family; the MoE family's raises) runs the
    prefill's stages under autograd, each layer under ``remat`` as the
    one-device form wraps it, and the mean cross-entropy of
    ``_mesh_ce_loss``.  Every collective's backward is its adjoint
    (sharding/collectives.py), so the gradient of each shard's part of a
    parameter is that shard's share of the whole gradient; the trainer
    sums the shares of a block over the shards that hold it."""
    a = cfg.attention
    tp = mesh.shape.get("model", 1)
    names = ("c", "krope") if a.is_mla else ("k", "v")
    n = len(mesh.devices)
    normed = partial(_normed, mesh=mesh, eps=cfg.norm_eps)

    def ffn(lp, hs, bspec):
        xs = normed(hs, lp["ln2"])
        if "mlp" in lp:
            ys = mlp_stage(lp["mlp"], xs, mesh, cfg.act, cfg.glu)
        elif mesh.shape.get(ep_axis, 1) == 1:
            # the one-shard path on the whole batch, as the reference's
            # program runs it (a dispatch's capacity is the whole batch's):
            # each shard gathers the batch over "data" and the layer, and
            # keeps its own rows of the output
            whole = tree_map(lambda t: replicated(t, mesh), lp["moe"])
            xa = xs if bspec is None else mesh_gather(xs, 0, mesh,
                                                      axis="data")

            def own(i, x):
                y = moe_forward(tree_map(lambda v: v[i], whole), cfg, x)[0]
                if bspec is None:
                    return y
                b = xs[i].shape[0]
                return y.narrow(0, mesh.axis_index(i, "data") * b, b)
            ys = _each(mesh, own, range(n), xa)
        else:
            spec = (bspec, None, None)
            y, _ = moe_forward(lp["moe"], cfg, join_spec(xs, spec, mesh),
                               mesh=mesh, ep_axis=ep_axis)
            ys = split_spec(y, spec, mesh)
        return _each(mesh, torch.add, hs, ys)

    def prefill_fn(params, batch):
        _check_tp(cfg, tp)
        tokens = batch["tokens"]
        b, s = tokens.shape
        bspec = _batch_spec(b, mesh)
        toks = split_spec(tokens, (bspec, None), mesh)
        hs = _embed_stage(params["emb"], toks, mesh)
        cache = {}
        for name, depth in stacks:
            got = []
            for i in range(depth):
                lp = _index(params[name], i)
                outs, kv = attn_stage(lp["attn"], a,
                                      normed(hs, lp["ln1"]), mesh,
                                      chunk=attn_chunk)
                hs = ffn(lp, _each(mesh, torch.add, hs, outs), bspec)
                got.append(kv)
            cache[name] = {
                key: ShardedLeaf([torch.stack([kv[sh][k] for kv in got])
                                  for sh in range(n)],
                                 _kv_spec(key, bspec), mesh)
                for k, key in enumerate(names)}
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        cache.update(_placed_positions(toks, s, mesh, bspec))
        return logits, cache

    def decode_fn(params, cache, batch):
        _check_tp(cfg, tp)
        bspec = cache["slot_pos"].spec[0]
        cur, slot_pos = _advance_shards(cache, mesh)
        hs = _embed_stage(params["emb"], split_spec(
            batch["tokens"], (bspec, None), mesh), mesh)
        for name, depth in stacks:
            lc = cache[name]
            for i in range(depth):
                lp = _index(params[name], i)
                caches = [{k: v.parts[sh][i] for k, v in lc.items()}
                          for sh in range(n)]
                outs = attn_decode_stage(lp["attn"], a,
                                         normed(hs, lp["ln1"]), cur,
                                         slot_pos, caches, mesh)
                hs = ffn(lp, _each(mesh, torch.add, hs, outs), bspec)
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        return logits, _stepped(cache, cur, slot_pos, mesh)

    def layer(lp, hs):
        outs, _ = attn_stage(lp["attn"], a, normed(hs, lp["ln1"]), mesh,
                             chunk=attn_chunk)
        return ffn(lp, _each(mesh, torch.add, hs, outs), None)

    train_layer = _remat(layer, remat)

    def loss_fn(params, batch):
        _check_tp(cfg, tp)
        tokens = batch["tokens"]
        b = tokens.shape[0]
        bspec = _batch_spec(b, mesh)
        toks = split_spec(tokens, (bspec, None), mesh)
        tgts = split_spec(batch["targets"], (bspec, None), mesh)
        hs = _embed_stage(params["emb"], toks, mesh)
        for name, depth in stacks:
            for i in range(depth):
                hs = train_layer(_index(params[name], i), hs)
        ce = _mesh_ce_loss(params, cfg, normed(hs, params["lnf"]), tgts,
                           mesh, bspec, b)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=F32,
                                                 device=mesh.device)}

    if cfg.family == "moe":
        loss_fn = _no_training(cfg)
    return loss_fn, prefill_fn, decode_fn


def _placed_positions(toks, s: int, mesh, bspec, cap: Optional[int] = None):
    """A prefill's slot table and ``cur`` (``_prefill_positions``) for
    each shard's rows ``toks``, held by batch rows."""
    pos = _each(mesh, lambda t: _prefill_positions(t.shape[0], s, t.device,
                                                   cap), toks)
    return {"slot_pos": ShardedLeaf([p for p, _ in pos], (bspec, None), mesh),
            "cur": ShardedLeaf([c for _, c in pos], (bspec,), mesh)}


def _stepped(cache, cur, slot_pos, mesh):
    """``cache`` after a decode step on ``mesh``: each shard's advanced
    slot table (``_advance_shards``) and its ``cur`` plus one."""
    out = dict(cache)
    out["slot_pos"] = ShardedLeaf(slot_pos, cache["slot_pos"].spec, mesh)
    out["cur"] = ShardedLeaf([c + 1 for c in cur], cache["cur"].spec, mesh)
    return out


def _advance_shards(cache, mesh):
    """``_advance_pos`` on every shard's slot table and ``cur``: (cur,
    slot_pos), one per shard."""
    table = cache["slot_pos"]
    cap = table.parts[0].shape[1]
    adv = _each(mesh, lambda c, t: _advance_pos({"cur": c, "slot_pos": t},
                                                cap),
                cache["cur"].parts, table.parts)
    return [c for c, _ in adv], [t for _, t in adv]


def place_cache(cfg: ArchConfig, cache, mesh):
    """The decoder bundle's ``place_cache``: a whole decoder cache
    (``init_cache``'s) placed as the decoder on ``mesh`` holds it: every
    shard's batch rows, and its KV heads (``shard_heads``) or MLA's
    latent; views on a simulated mesh."""
    tp = mesh.shape.get("model", 1)
    heads = [shard_heads(cfg.attention, tp, j) for j in range(tp)]
    bspec = _batch_spec(cache["cur"].shape[0], mesh)

    def place(path, t):
        key = path[-1]
        if key == "cur":
            return ShardedLeaf(respec(t, (bspec,), mesh), (bspec,), mesh)
        if key == "slot_pos":
            return ShardedLeaf(respec(t, (bspec, None), mesh),
                               (bspec, None), mesh)
        lead = t.dim() - (4 if key in ("k", "v") else 3)
        spec = _kv_spec(key, bspec, lead)
        parts = respec(t, spec[:lead + 2] + (None,) * (t.dim() - lead - 2),
                       mesh)
        if key in ("k", "v"):
            parts = [p.narrow(lead + 2, k0, k1 - k0) for p, (_, _, k0, k1)
                     in zip(parts, (heads[mesh.axis_index(i, "model")]
                                    for i in range(len(parts))))]
        return ShardedLeaf(parts, spec, mesh)
    return tree_map_with_path(place, cache)


def join_cache(cfg: ArchConfig, cache):
    """The decoder bundle's ``join_cache``: a cache placed on a mesh put
    together on the lead device, in the one-device layout: each KV head
    once."""
    def join(path, t):
        if not isinstance(t, ShardedLeaf):
            return t
        whole = t.join()
        if path[-1] in ("k", "v"):
            whole = whole[..., ::whole.shape[-2]
                          // cfg.attention.n_kv_heads, :]
        return whole
    return tree_map_with_path(join, cache)


# ---------------------------------------------------------------------------
# zamba2 hybrid: groups of (shared_attn_every-1 mamba + shared block)
# ---------------------------------------------------------------------------
def build_hybrid(cfg: ArchConfig, rules=None, mesh=None,
                 remat: str = "full",
                 attn_chunk: int = 1024) -> ModelBundle:
    per = cfg.shared_attn_every
    n_groups = cfg.n_layers // per
    n_m = per - 1
    n_tail = cfg.n_layers - n_groups * per

    decls = _emb_decls(cfg)
    decls["mamba"] = stack_decls(stack_decls(S.mamba2_decls(cfg), n_m),
                                 n_groups)
    if n_tail:
        decls["tail"] = stack_decls(S.mamba2_decls(cfg), n_tail)
    decls["shared"] = _dense_layer_decls(cfg)   # ONE param set, 13 uses

    def shared_block(h, params):      # queries at arange(S): positions None
        lp = params["shared"]
        a, kv = attn_forward(lp["attn"], cfg.attention,
                             rms_norm(h, lp["ln1"], cfg.norm_eps),
                             chunk=attn_chunk)
        return _mlp_block(cfg, lp, h + a), kv

    # the training form's mamba blocks, under remat (the shared block is
    # not wrapped, as in the reference)
    mamba = _remat(lambda lp, h: S.mamba2_forward(lp, cfg, h), remat)

    def backbone(params, tokens, collect=False):
        h = _embed(params, tokens)
        m_ssm, m_conv, ks, vs = [], [], [], []
        for g in range(n_groups):
            for i in range(n_m):
                lp = _index(params["mamba"], g, i)
                if collect:
                    h, (s_fin, conv_state) = S.mamba2_forward(
                        lp, cfg, h, return_state=True)
                    m_ssm.append(s_fin)
                    m_conv.append(conv_state)
                else:
                    h = mamba(lp, h)
            h, (k, v) = shared_block(h, params)
            if collect:
                ks.append(k)
                vs.append(v)
        t_ssm, t_conv = [], []
        for i in range(n_tail):
            lp = _index(params["tail"], i)
            if collect:
                h, (s_fin, conv_state) = S.mamba2_forward(
                    lp, cfg, h, return_state=True)
                t_ssm.append(s_fin)
                t_conv.append(conv_state)
            else:
                h = mamba(lp, h)
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        if not collect:
            return h, None
        states = {
            "m_ssm": _stacked(m_ssm, n_groups, n_m),
            "m_conv": _stacked(m_conv, n_groups, n_m),
            "k": torch.stack(ks), "v": torch.stack(vs),
        }
        if n_tail:
            states["t_ssm"] = torch.stack(t_ssm)
            states["t_conv"] = torch.stack(t_conv)
        return h, states

    def loss_fn(params, batch):
        h, _ = backbone(params, batch["tokens"])
        ce = chunked_ce_loss(_unemb(params, cfg), h, batch["targets"])
        return ce, {"ce": ce}

    def cache_decls(shape: ShapeConfig):
        b = shape.global_batch
        s2 = cfg.ssm
        di = s2.expand * cfg.d_model
        nh = di // s2.head_dim
        kv, cap = _kv_cache_decls(cfg, 0, b, shape.seq_len, prefix=(n_groups,))
        out = {
            "m_ssm": PDecl((n_groups, n_m, b, nh, s2.state_dim, s2.head_dim),
                           (None, None, "batch", None, None, None),
                           dtype=F32, init="zeros"),
            "m_conv": PDecl((n_groups, n_m, b, s2.conv_dim - 1,
                             di + 2 * s2.state_dim),
                            (None, None, "batch", None, None), init="zeros"),
            "shared_kv": kv,
        }
        if n_tail:
            out["t_ssm"] = PDecl((n_tail, b, nh, s2.state_dim, s2.head_dim),
                                 (None, "batch", None, None, None),
                                 dtype=F32, init="zeros")
            out["t_conv"] = PDecl((n_tail, b, s2.conv_dim - 1,
                                   di + 2 * s2.state_dim),
                                  (None, "batch", None, None), init="zeros")
        out.update(_pos_decls(b, cap))
        return out

    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        h, st = backbone(params, tokens, collect=True)
        logits = _last_logits(_unemb(params, cfg), h)
        a = cfg.attention
        cap = min(s, a.sliding_window) if a.sliding_window else s
        cache = {
            "m_ssm": st["m_ssm"], "m_conv": st["m_conv"],
            "shared_kv": {"k": st["k"][:, :, -cap:], "v": st["v"][:, :, -cap:]},
        }
        cache["slot_pos"], cache["cur"] = _prefill_positions(
            b, s, tokens.device, cap)
        if n_tail:
            cache["t_ssm"], cache["t_conv"] = st["t_ssm"], st["t_conv"]
        return logits, cache

    def decode_fn(params, cache, batch):
        cap = cache["slot_pos"].shape[1]
        cur, slot_pos = _advance_pos(cache, cap)
        h = _embed(params, batch["tokens"])

        def mamba_step(h, lp, ssm_st, conv_st):
            h, st = S.mamba2_decode(lp, cfg, h, {"ssm": ssm_st,
                                                 "conv": conv_st})
            ssm_st.copy_(st["ssm"])
            conv_st.copy_(st["conv"])
            return h

        kv = cache["shared_kv"]
        for g in range(n_groups):
            for i in range(n_m):
                h = mamba_step(h, _index(params["mamba"], g, i),
                               cache["m_ssm"][g, i], cache["m_conv"][g, i])
            lp = params["shared"]
            a, _ = attn_decode(lp["attn"], cfg.attention,
                               rms_norm(h, lp["ln1"], cfg.norm_eps),
                               cur, slot_pos,
                               {"k": kv["k"][g], "v": kv["v"][g]})
            h = _mlp_block(cfg, lp, h + a)
        for i in range(n_tail):
            h = mamba_step(h, _index(params["tail"], i),
                           cache["t_ssm"][i], cache["t_conv"][i])
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["slot_pos"] = slot_pos
        out["cur"] = cur + 1
        return logits, out

    bundle = ModelBundle(cfg, decls, loss_fn, prefill_fn, decode_fn,
                         cache_decls, _train_specs(_token_specs))
    return _on_mesh(bundle, rules, mesh, lambda b: _hybrid_on_mesh(
        b, mesh, n_groups, n_m, n_tail, attn_chunk))


# ---------------------------------------------------------------------------
# the hybrid on a mesh: the Mamba-2 blocks' SSM heads, the shared block's
# attention heads and MLP width and the vocabulary over "model"; FSDP and
# the batch over "data"
# ---------------------------------------------------------------------------
_SSM_STATES = ("m_ssm", "t_ssm")
_CONV_STATES = ("m_conv", "t_conv")


def _hybrid_on_mesh(bundle: ModelBundle, mesh, n_groups: int, n_m: int,
                    n_tail: int, attn_chunk: int) -> ModelBundle:
    """The hybrid ``bundle`` tensor parallel on ``mesh``, its blocks as
    stages run on each shard in shard order between collectives, as
    ``_decoder_on_mesh`` runs the decoder's: every Mamba-2 block through
    ``ssm.mamba2_stage`` / ``mamba2_decode_stage`` (its SSM heads over
    "model"), the shared block through ``attn_stage`` /
    ``attn_decode_stage`` and ``mlp_stage`` at every application, the
    vocab-parallel lookup and logits; the batch rows, positions and every
    cache leaf over "data".  The cache is held by heads: each shard's SSM
    states of its heads, its conv window of its x channels with bm and cm
    (whole on every model shard), the shared block's keys and values of
    its KV heads (``_kv_spec``)."""
    cfg = bundle.arch
    a = cfg.attention
    tp = mesh.shape.get("model", 1)
    n = len(mesh.devices)
    normed = partial(_normed, mesh=mesh, eps=cfg.norm_eps)
    mlp_half = partial(_mlp_half, cfg, mesh=mesh)

    def prefill_fn(params, batch):
        _check_tp(cfg, tp)
        tokens = batch["tokens"]
        b, s = tokens.shape
        bspec = _batch_spec(b, mesh)
        toks = split_spec(tokens, (bspec, None), mesh)
        hs = _embed_stage(params["emb"], toks, mesh)
        lp = params["shared"]
        mamba, tail, kvs = [], [], []
        for g in range(n_groups):
            for i in range(n_m):
                hs, st = S.mamba2_stage(_index(params["mamba"], g, i), cfg,
                                        hs, mesh)
                mamba.append(st)
            outs, kv = attn_stage(lp["attn"], a, normed(hs, lp["ln1"]), mesh,
                                  chunk=attn_chunk)
            hs = mlp_half(lp, _each(mesh, torch.add, hs, outs))
            kvs.append(kv)
        for i in range(n_tail):
            hs, st = S.mamba2_stage(_index(params["tail"], i), cfg, hs, mesh)
            tail.append(st)
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        cap = min(s, a.sliding_window) if a.sliding_window else s

        def held(got, k, lead, spec):
            return ShardedLeaf([_stacked([st[sh][k] for st in got], *lead)
                                for sh in range(n)], spec, mesh)
        cache = {
            "m_ssm": held(mamba, 0, (n_groups, n_m),
                          (None, None, bspec, "model", None, None)),
            "m_conv": held(mamba, 1, (n_groups, n_m),
                           (None, None, bspec, None, "model")),
            "shared_kv": {key: ShardedLeaf(
                [torch.stack([kv[sh][k] for kv in kvs])[:, :, -cap:]
                 for sh in range(n)], _kv_spec(key, bspec), mesh)
                for k, key in enumerate(("k", "v"))},
        }
        if n_tail:
            cache["t_ssm"] = held(tail, 0, (n_tail,),
                                  (None, bspec, "model", None, None))
            cache["t_conv"] = held(tail, 1, (n_tail,),
                                   (None, bspec, None, "model"))
        cache.update(_placed_positions(toks, s, mesh, bspec, cap))
        return logits, cache

    def decode_fn(params, cache, batch):
        _check_tp(cfg, tp)
        bspec = cache["slot_pos"].spec[0]
        cur, slot_pos = _advance_shards(cache, mesh)
        hs = _embed_stage(params["emb"], split_spec(
            batch["tokens"], (bspec, None), mesh), mesh)

        def mamba_step(hs, lp, ssm, conv):
            """One block's step; its states (a layer's view of each
            shard's part) updated in place."""
            hs, new = S.mamba2_decode_stage(
                lp, cfg, hs, [{"ssm": x, "conv": c}
                              for x, c in zip(ssm, conv)], mesh)
            for x, c, st in zip(ssm, conv, new):
                x.copy_(st["ssm"])
                c.copy_(st["conv"])
            return hs

        kv = cache["shared_kv"]
        lp = params["shared"]
        for g in range(n_groups):
            for i in range(n_m):
                hs = mamba_step(hs, _index(params["mamba"], g, i),
                                [t[g, i] for t in cache["m_ssm"].parts],
                                [t[g, i] for t in cache["m_conv"].parts])
            caches = [{"k": kv["k"].parts[sh][g], "v": kv["v"].parts[sh][g]}
                      for sh in range(n)]
            outs = attn_decode_stage(lp["attn"], a, normed(hs, lp["ln1"]),
                                     cur, slot_pos, caches, mesh)
            hs = mlp_half(lp, _each(mesh, torch.add, hs, outs))
        for i in range(n_tail):
            hs = mamba_step(hs, _index(params["tail"], i),
                            [t[i] for t in cache["t_ssm"].parts],
                            [t[i] for t in cache["t_conv"].parts])
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        return logits, _stepped(cache, cur, slot_pos, mesh)

    return replace(bundle, loss_fn=_no_training(cfg), prefill_fn=prefill_fn,
                   decode_fn=decode_fn,
                   place_cache=partial(_place_hybrid_cache, cfg, mesh=mesh),
                   join_cache=partial(_join_hybrid_cache, cfg), mesh=mesh)


def _place_hybrid_cache(cfg: ArchConfig, cache, mesh):
    """A whole hybrid cache (``init_cache``'s) placed as the hybrid on
    ``mesh`` holds it: the shared keys, values and positions as the
    decoder's (``place_cache``); each shard's SSM states of its heads and
    conv window of its x channels and bm, cm, copies of its own (a decode
    step updates them in place)."""
    out = place_cache(cfg, {k: v for k, v in cache.items()
                            if k not in _SSM_STATES + _CONV_STATES}, mesh)
    s = cfg.ssm
    tp = mesh.shape.get("model", 1)
    dl = S.tp_ssm_heads(cfg, tp) * s.head_dim
    di = dl * tp
    bspec = _batch_spec(cache["cur"].shape[0], mesh)
    for key in _SSM_STATES:
        if key in cache:
            lead = cache[key].dim() - 4
            spec = (None,) * lead + (bspec, "model", None, None)
            out[key] = ShardedLeaf([p.clone() for p in respec(
                cache[key], spec, mesh)], spec, mesh)
    for key in _CONV_STATES:
        if key in cache:
            lead = cache[key].dim() - 3
            rows = respec(cache[key], (None,) * lead + (bspec, None, None),
                          mesh)
            parts = [torch.cat([p.narrow(-1, mesh.axis_index(i, "model")
                                         * dl, dl),
                                p.narrow(-1, di, 2 * s.state_dim)], dim=-1)
                     for i, p in enumerate(rows)]
            out[key] = ShardedLeaf(parts, (None,) * lead
                                   + (bspec, None, "model"), mesh)
    return out


def _join_hybrid_cache(cfg: ArchConfig, cache):
    """A hybrid cache placed on a mesh put together on the lead device in
    the one-device layout: each KV head once, every shard's SSM heads, the
    conv window's x channels of every shard and bm, cm once."""
    out = join_cache(cfg, {k: v for k, v in cache.items()
                           if k not in _CONV_STATES})
    n2 = 2 * cfg.ssm.state_dim
    for key in _CONV_STATES:
        if key in cache:
            leaf = cache[key]
            dl = leaf.parts[0].shape[-1] - n2
            xs = join_spec([p[..., :dl] for p in leaf.parts], leaf.spec,
                           leaf.mesh)
            bc = join_spec([p[..., dl:] for p in leaf.parts],
                           leaf.spec[:-1] + (None,), leaf.mesh)
            out[key] = torch.cat([xs, bc], dim=-1)
    return out


# ---------------------------------------------------------------------------
# xLSTM: groups of (slstm_every - 1) mLSTM blocks and one sLSTM block
# ---------------------------------------------------------------------------
def build_xlstm(cfg: ArchConfig, rules=None, mesh=None,
                remat: str = "full",
                attn_chunk: int = 1024) -> ModelBundle:
    """The reference's ``build_xlstm``: ``mlstm`` stacked (groups, mLSTM
    blocks a group), ``slstm`` stacked (groups,).  The reduced config
    keeps slstm_every 8 at 4 layers, so it has no group at all (embedding,
    final norm and unembedding only), as in the reference.  The cache
    holds each mLSTM's (N, P) state and conv window and each sLSTM's
    carry; it does not grow."""
    per = cfg.ssm.slstm_every or cfg.n_layers
    n_groups = cfg.n_layers // per
    n_m = per - 1 if cfg.ssm.slstm_every else per
    has_s = bool(cfg.ssm.slstm_every)
    nh = cfg.attention.n_heads
    di = cfg.ssm.expand * cfg.d_model
    hd, shd = di // nh, cfg.d_model // nh

    decls = _emb_decls(cfg)
    decls["mlstm"] = stack_decls(stack_decls(S.mlstm_decls(cfg), n_m),
                                 n_groups)
    if has_s:
        decls["slstm"] = stack_decls(S.slstm_decls(cfg), n_groups)

    # the training form's mLSTM blocks, under remat (the sLSTM block is
    # not wrapped, as in the reference)
    mlstm = _remat(lambda lp, h: S.mlstm_forward(lp, cfg, h), remat)

    def loss_fn(params, batch):
        h = _embed(params, batch["tokens"])
        for g in range(n_groups):
            for i in range(n_m):
                h = mlstm(_index(params["mlstm"], g, i), h)
            if has_s:
                h = S.slstm_forward(_index(params["slstm"], g), cfg, h)
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        ce = chunked_ce_loss(_unemb(params, cfg), h, batch["targets"])
        return ce, {"ce": ce}

    def cache_decls(shape: ShapeConfig):
        b = shape.global_batch
        out = {
            "m_ssm": PDecl((n_groups, n_m, b, nh, hd, hd + 1),
                           (None, None, "batch", None, None, None), dtype=F32,
                           init="zeros"),
            "m_conv": PDecl((n_groups, n_m, b, cfg.ssm.conv_dim - 1, di),
                            (None, None, "batch", None, None), init="zeros"),
            "cur": PDecl((b,), ("batch",), dtype=I32, init="zeros"),
        }
        if has_s:
            out["s_state"] = PDecl((n_groups, 4, b, nh, shd),
                                   (None, None, "batch", None, None),
                                   dtype=F32, init="zeros")
        return out

    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = _embed(params, tokens)
        dev = h.device
        # filled layer by layer (zero groups leave them empty)
        cache = {
            "m_ssm": torch.empty((n_groups, n_m, b, nh, hd, hd + 1),
                                 dtype=F32, device=dev),
            "m_conv": torch.empty((n_groups, n_m, b, cfg.ssm.conv_dim - 1,
                                   di), dtype=h.dtype, device=dev),
            "cur": torch.full((b,), s, dtype=I32, device=dev),
        }
        if has_s:
            cache["s_state"] = torch.empty((n_groups, 4, b, nh, shd),
                                           dtype=F32, device=dev)
        for g in range(n_groups):
            for i in range(n_m):
                h, (s_fin, conv_state) = S.mlstm_forward(
                    _index(params["mlstm"], g, i), cfg, h, return_state=True)
                cache["m_ssm"][g, i] = s_fin
                cache["m_conv"][g, i] = conv_state
            if has_s:
                h, carry = S.slstm_forward(_index(params["slstm"], g), cfg,
                                           h, return_state=True)
                cache["s_state"][g] = torch.stack(carry)
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        return _last_logits(_unemb(params, cfg), h), cache

    def decode_fn(params, cache, batch):
        h = _embed(params, batch["tokens"])
        for g in range(n_groups):
            for i in range(n_m):
                ssm_st, conv_st = cache["m_ssm"][g, i], cache["m_conv"][g, i]
                h, st = S.mlstm_decode(_index(params["mlstm"], g, i), cfg, h,
                                       {"ssm": ssm_st, "conv": conv_st})
                ssm_st.copy_(st["ssm"])
                conv_st.copy_(st["conv"])
            if has_s:
                sst = cache["s_state"][g]
                h, carry = S.slstm_decode(_index(params["slstm"], g), cfg, h,
                                          tuple(sst))
                sst.copy_(torch.stack(carry))
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["cur"] = cache["cur"] + 1
        return logits, out

    bundle = ModelBundle(cfg, decls, loss_fn, prefill_fn, decode_fn,
                         cache_decls, _train_specs(_token_specs))
    return _on_mesh(bundle, rules, mesh)


# ---------------------------------------------------------------------------
# encoder-decoder (whisper): a non-causal encoder over precomputed frames,
# a decoder with self- and cross-attention
# ---------------------------------------------------------------------------
def build_encdec(cfg: ArchConfig, rules=None, mesh=None,
                 remat: str = "full",
                 attn_chunk: int = 1024) -> ModelBundle:
    """The reference's ``build_encdec``.  Sinusoidal positions, no rope.
    The prefill encodes ``batch["frames"]`` (B, T, d_frontend) and runs the
    decoder over the prompt; its cache holds the decoder's self keys and
    values and the cross keys and values of the encoder's output (T
    rows, never grown nor written).  A decode step adds the sinusoid of
    position 0 to its token, as the reference does (not that of its
    position)."""
    a = cfg.attention
    eps = cfg.norm_eps
    decls = _emb_decls(cfg)
    decls["frontend_proj"] = PDecl((cfg.d_frontend, cfg.d_model),
                                   ("frontend", "embed"))
    enc_layer = _dense_layer_decls(cfg)
    dec_layer = dict(enc_layer)
    dec_layer["lnx"] = PDecl((cfg.d_model,), (None,), init="ones")
    dec_layer["cross"] = attn_decls(a, cfg.d_model)
    decls["encoder"] = stack_decls(enc_layer, cfg.n_encoder_layers)
    decls["decoder"] = stack_decls(dec_layer, cfg.n_layers)
    decls["enc_lnf"] = PDecl((cfg.d_model,), (None,), init="ones")

    def enc_layer(lp, h):
        att, _ = attn_forward(lp["attn"], a, rms_norm(h, lp["ln1"], eps),
                              use_rope=False, chunk=attn_chunk, causal=False)
        return _mlp_block(cfg, lp, h + att)

    def dec_layer(lp, h, enc):
        """(h, the self and cross keys and values)."""
        att, kv = attn_forward(lp["attn"], a, rms_norm(h, lp["ln1"], eps),
                               use_rope=False, chunk=attn_chunk)
        h = h + att
        c, xkv = attn_forward(lp["cross"], a, rms_norm(h, lp["lnx"], eps),
                              use_rope=False, chunk=attn_chunk,
                              kv_override=(enc, None))
        return _mlp_block(cfg, lp, h + c), kv + xkv

    # the training form's layers, under remat (both stacks, as the
    # reference wraps them)
    train_enc = _remat(enc_layer, remat)
    train_dec = _remat(lambda lp, h, enc: dec_layer(lp, h, enc)[0], remat)

    def encode(params, frames, train: bool = False):
        proj = params["frontend_proj"]
        h = frames.to(proj.dtype) @ proj
        h = h + sinusoidal_pos(h.shape[1], cfg.d_model, h.dtype,
                               h.device)[None]
        for i in range(cfg.n_encoder_layers):
            h = (train_enc if train else enc_layer)(
                _index(params["encoder"], i), h)
        return rms_norm(h, params["enc_lnf"], eps)

    def _tokens_in(params, tokens, n_pos: int):
        """Token embeddings plus the bf16 sinusoid of positions 0 ..
        n_pos - 1 (the reference's default type, promoted)."""
        h = _embed(params, tokens)
        return h + sinusoidal_pos(n_pos, cfg.d_model,
                                  device=h.device).to(h.dtype)[None]

    def loss_fn(params, batch):
        enc = encode(params, batch["frames"], train=True)
        tokens = batch["tokens"]
        h = _tokens_in(params, tokens, tokens.shape[1])
        for i in range(cfg.n_layers):
            h = train_dec(_index(params["decoder"], i), h, enc)
        h = rms_norm(h, params["lnf"], eps)
        ce = chunked_ce_loss(_unemb(params, cfg), h, batch["targets"])
        return ce, {"ce": ce}

    def cache_decls(shape: ShapeConfig):
        b = shape.global_batch
        kv, cap = _kv_cache_decls(cfg, cfg.n_layers, b, shape.seq_len)
        xkv, _ = _kv_cache_decls(cfg, cfg.n_layers, b, shape.seq_len)
        out = {"self_kv": kv, "cross_kv": xkv}
        out.update(_pos_decls(b, cap))
        return out

    def prefill_fn(params, batch):
        enc = encode(params, batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = _tokens_in(params, tokens, s)
        kvs = []
        for i in range(cfg.n_layers):
            h, kv = dec_layer(_index(params["decoder"], i), h, enc)
            kvs.append(kv)
        h = rms_norm(h, params["lnf"], eps)
        logits = _last_logits(_unemb(params, cfg), h)
        k, v, xk, xv = (torch.stack(t) for t in zip(*kvs))
        slot_pos, cur = _prefill_positions(b, s, tokens.device)
        cache = {"self_kv": {"k": k, "v": v}, "cross_kv": {"k": xk, "v": xv},
                 "slot_pos": slot_pos, "cur": cur}
        return logits, cache

    def decode_fn(params, cache, batch):
        cap = cache["slot_pos"].shape[1]
        cur, slot_pos = _advance_pos(cache, cap)
        h = _tokens_in(params, batch["tokens"], 1)
        for i in range(cfg.n_layers):
            lp = _index(params["decoder"], i)
            att, _ = attn_decode(lp["attn"], a, rms_norm(h, lp["ln1"], eps),
                                 cur, slot_pos, _index(cache["self_kv"], i),
                                 use_rope=False)
            h = h + att
            c, _ = attn_decode(lp["cross"], a, rms_norm(h, lp["lnx"], eps),
                               cur, slot_pos, _index(cache["cross_kv"], i),
                               use_rope=False, cross=True)
            h = _mlp_block(cfg, lp, h + c)
        h = rms_norm(h, params["lnf"], eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["slot_pos"] = slot_pos
        out["cur"] = cur + 1
        return logits, out

    def input_specs(shape: ShapeConfig):
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": PDecl((b, 1), ("batch", None), dtype=I32)}
        specs = {
            "frames": PDecl((b, s, cfg.d_frontend),
                            ("batch", "seq_shard", None)),
            "tokens": PDecl((b, s), ("batch", None), dtype=I32),
        }
        if shape.kind == "train":
            specs["targets"] = PDecl((b, s), ("batch", None), dtype=I32)
        return specs

    bundle = ModelBundle(cfg, decls, loss_fn, prefill_fn, decode_fn,
                         cache_decls, input_specs)
    return _on_mesh(bundle, rules, mesh)


# ---------------------------------------------------------------------------
# VLM: a decoder with a gated cross-attention layer every Nth layer
# ---------------------------------------------------------------------------
def build_vlm(cfg: ArchConfig, rules=None, mesh=None,
              remat: str = "full",
              attn_chunk: int = 1024) -> ModelBundle:
    """The reference's ``build_vlm``: groups of ``cross_attn_every - 1``
    self-attention layers (rope, causal) and one cross-attention layer
    against the projected image patches ``batch["img"]`` (no rope, not
    causal), whose output is scaled by tanh(gate) (the gate is declared
    zero-initialised, which cancels it).  The cache holds the self keys
    and values (groups, self layers) and the cross ones (groups,), never
    grown nor written."""
    per = cfg.cross_attn_every
    n_groups = cfg.n_layers // per
    n_self = per - 1
    a = cfg.attention
    eps = cfg.norm_eps

    decls = _emb_decls(cfg)
    decls["img_proj"] = PDecl((cfg.d_frontend, cfg.d_model),
                              ("frontend", "embed"))
    decls["self_layers"] = stack_decls(
        stack_decls(_dense_layer_decls(cfg), n_self), n_groups)
    cross_layer = dict(_dense_layer_decls(cfg))
    cross_layer["gate"] = PDecl((1,), (None,), dtype=F32, init="zeros")
    decls["cross_layers"] = stack_decls(cross_layer, n_groups)

    def gated(cp, h, att):
        return h + torch.tanh(cp["gate"]).to(h.dtype) * att

    def self_layer(lp, h):
        att, kv = attn_forward(lp["attn"], a, rms_norm(h, lp["ln1"], eps),
                               chunk=attn_chunk)
        return _mlp_block(cfg, lp, h + att), kv

    def cross_layer(cp, h, img_h):
        att, xkv = attn_forward(cp["attn"], a, rms_norm(h, cp["ln1"], eps),
                                use_rope=False, chunk=attn_chunk,
                                kv_override=(img_h, None))
        return _mlp_block(cfg, cp, gated(cp, h, att)), xkv

    # the training form's self-attention layers, under remat (the cross
    # layer is not wrapped, as in the reference)
    train_self = _remat(lambda lp, h: self_layer(lp, h)[0], remat)

    def loss_fn(params, batch):
        proj = params["img_proj"]
        img_h = batch["img"].to(proj.dtype) @ proj
        h = _embed(params, batch["tokens"])
        for g in range(n_groups):
            for i in range(n_self):
                h = train_self(_index(params["self_layers"], g, i), h)
            h = cross_layer(_index(params["cross_layers"], g), h, img_h)[0]
        h = rms_norm(h, params["lnf"], eps)
        ce = chunked_ce_loss(_unemb(params, cfg), h, batch["targets"])
        return ce, {"ce": ce}

    def cache_decls(shape: ShapeConfig):
        b = shape.global_batch
        kv, cap = _kv_cache_decls(cfg, n_self, b, shape.seq_len,
                                  prefix=(n_groups,))
        xshape = (n_groups, b, cfg.n_frontend_tokens, a.n_kv_heads,
                  a.head_dim)
        names = (None, "batch", None, None, None)
        out = {"self_kv": kv,
               "cross_kv": {"k": PDecl(xshape, names),
                            "v": PDecl(xshape, names)}}
        out.update(_pos_decls(b, cap))
        return out

    def prefill_fn(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        proj = params["img_proj"]
        img_h = batch["img"].to(proj.dtype) @ proj
        h = _embed(params, tokens)
        kvs, xkvs = [], []
        for g in range(n_groups):
            for i in range(n_self):
                h, kv = self_layer(_index(params["self_layers"], g, i), h)
                kvs.append(kv)
            h, xkv = cross_layer(_index(params["cross_layers"], g), h, img_h)
            xkvs.append(xkv)
        h = rms_norm(h, params["lnf"], eps)
        logits = _last_logits(_unemb(params, cfg), h)
        k, v = (_stacked(t, n_groups, n_self) for t in zip(*kvs))
        xk, xv = (torch.stack(t) for t in zip(*xkvs))
        slot_pos, cur = _prefill_positions(b, s, tokens.device)
        cache = {"self_kv": {"k": k, "v": v}, "cross_kv": {"k": xk, "v": xv},
                 "slot_pos": slot_pos, "cur": cur}
        return logits, cache

    def decode_fn(params, cache, batch):
        cap = cache["slot_pos"].shape[1]
        cur, slot_pos = _advance_pos(cache, cap)
        h = _embed(params, batch["tokens"])
        for g in range(n_groups):
            for i in range(n_self):
                lp = _index(params["self_layers"], g, i)
                att, _ = attn_decode(lp["attn"], a,
                                     rms_norm(h, lp["ln1"], eps), cur,
                                     slot_pos, _index(cache["self_kv"], g, i))
                h = _mlp_block(cfg, lp, h + att)
            cp = _index(params["cross_layers"], g)
            att, _ = attn_decode(cp["attn"], a, rms_norm(h, cp["ln1"], eps),
                                 cur, slot_pos, _index(cache["cross_kv"], g),
                                 use_rope=False, cross=True)
            h = _mlp_block(cfg, cp, gated(cp, h, att))
        h = rms_norm(h, params["lnf"], eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["slot_pos"] = slot_pos
        out["cur"] = cur + 1
        return logits, out

    def input_specs(shape: ShapeConfig):
        b = shape.global_batch
        s = shape.seq_len if shape.kind != "decode" else 1
        specs = {"tokens": PDecl((b, s), ("batch", None), dtype=I32)}
        if shape.kind != "decode":     # decode: the image lives in the cache
            specs["img"] = PDecl((b, cfg.n_frontend_tokens, cfg.d_frontend),
                                 ("batch", None, None))
        if shape.kind == "train":
            specs["targets"] = PDecl((b, s), ("batch", None), dtype=I32)
        return specs

    bundle = ModelBundle(cfg, decls, loss_fn, prefill_fn, decode_fn,
                         cache_decls, input_specs)
    return _on_mesh(bundle, rules, mesh, lambda b: _vlm_on_mesh(
        b, mesh, n_groups, n_self, attn_chunk))


# ---------------------------------------------------------------------------
# the VLM on a mesh: the decoder's stages for its self-attention layers, a
# cross-attention stage against the projected image, the gate after the
# sum over "model"
# ---------------------------------------------------------------------------
def _vlm_on_mesh(bundle: ModelBundle, mesh, n_groups: int, n_self: int,
                 attn_chunk: int) -> ModelBundle:
    """The VLM ``bundle`` tensor parallel on ``mesh``, as
    ``_decoder_on_mesh`` runs the decoder: the self-attention layers
    through ``attn_stage`` / ``attn_decode_stage`` and ``mlp_stage``, the
    vocab-parallel lookup and logits, the batch rows, image patches, cache
    and positions over "data".  The image is projected on each shard
    (``img_proj`` gathered whole where FSDP places it over "data"), and
    each cross-attention layer is ``attn_stage`` against it: each shard
    projects its own KV heads' keys and values from the image (no rope,
    no mask), and the gate scales the output after its float32 sum over
    "model" (``h + tanh(gate) * sum``, as the reference scales the whole
    output).  The cache is held by KV heads and batch rows, the cross
    keys and values as the self ones (``_kv_spec``), where the reference
    declares the cross cache by batch rows alone (the values are the
    same); the decoder's ``place_cache`` and ``join_cache`` serve it.
    Training on a mesh is not ported."""
    cfg = bundle.arch
    a = cfg.attention
    tp = mesh.shape.get("model", 1)
    n = len(mesh.devices)
    normed = partial(_normed, mesh=mesh, eps=cfg.norm_eps)
    mlp_half = partial(_mlp_half, cfg, mesh=mesh)
    names = ("k", "v")

    def gated(cp, hs, outs):
        return _each(mesh, lambda h, o, g: h + torch.tanh(g).to(h.dtype) * o,
                     hs, outs, replicated(cp["gate"], mesh))

    def prefill_fn(params, batch):
        _check_tp(cfg, tp)
        tokens = batch["tokens"]
        b, s = tokens.shape
        bspec = _batch_spec(b, mesh)
        toks = split_spec(tokens, (bspec, None), mesh)
        imgs = split_spec(batch["img"], (bspec, None, None), mesh)
        img_h = _each(mesh, lambda x, w: x.to(w.dtype) @ w, imgs,
                      replicated(params["img_proj"], mesh))
        hs = _embed_stage(params["emb"], toks, mesh)
        kvs, xkvs = [], []
        for g in range(n_groups):
            for i in range(n_self):
                lp = _index(params["self_layers"], g, i)
                outs, kv = attn_stage(lp["attn"], a, normed(hs, lp["ln1"]),
                                      mesh, chunk=attn_chunk)
                hs = mlp_half(lp, _each(mesh, torch.add, hs, outs))
                kvs.append(kv)
            cp = _index(params["cross_layers"], g)
            outs, xkv = attn_stage(cp["attn"], a, normed(hs, cp["ln1"]),
                                   mesh, chunk=attn_chunk, kv_xs=img_h)
            hs = mlp_half(cp, gated(cp, hs, outs))
            xkvs.append(xkv)
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        cache = {
            "self_kv": {key: ShardedLeaf(
                [_stacked([kv[sh][k] for kv in kvs], n_groups, n_self)
                 for sh in range(n)], _kv_spec(key, bspec, 2), mesh)
                for k, key in enumerate(names)},
            "cross_kv": {key: ShardedLeaf(
                [torch.stack([kv[sh][k] for kv in xkvs]) for sh in range(n)],
                _kv_spec(key, bspec), mesh)
                for k, key in enumerate(names)},
        }
        cache.update(_placed_positions(toks, s, mesh, bspec))
        return logits, cache

    def decode_fn(params, cache, batch):
        _check_tp(cfg, tp)
        bspec = cache["slot_pos"].spec[0]
        cur, slot_pos = _advance_shards(cache, mesh)
        hs = _embed_stage(params["emb"], split_spec(
            batch["tokens"], (bspec, None), mesh), mesh)
        sk, xk = cache["self_kv"], cache["cross_kv"]
        for g in range(n_groups):
            for i in range(n_self):
                lp = _index(params["self_layers"], g, i)
                caches = [{k: v.parts[sh][g, i] for k, v in sk.items()}
                          for sh in range(n)]
                outs = attn_decode_stage(lp["attn"], a,
                                         normed(hs, lp["ln1"]), cur,
                                         slot_pos, caches, mesh)
                hs = mlp_half(lp, _each(mesh, torch.add, hs, outs))
            cp = _index(params["cross_layers"], g)
            caches = [{k: v.parts[sh][g] for k, v in xk.items()}
                      for sh in range(n)]
            outs = attn_decode_stage(cp["attn"], a, normed(hs, cp["ln1"]),
                                     cur, slot_pos, caches, mesh, cross=True)
            hs = mlp_half(cp, gated(cp, hs, outs))
        logits = _logits_stage(params, cfg, normed(hs, params["lnf"]), mesh,
                               bspec)
        return logits, _stepped(cache, cur, slot_pos, mesh)

    return replace(bundle, loss_fn=_no_training(cfg), prefill_fn=prefill_fn,
                   decode_fn=decode_fn,
                   place_cache=lambda c: place_cache(cfg, c, mesh),
                   join_cache=partial(join_cache, cfg), mesh=mesh)


# ---------------------------------------------------------------------------
# the data-parallel form: the batch over every mesh axis the rules give it,
# the parameters gathered whole, each shard the family's one-device step
# ---------------------------------------------------------------------------
# the batch's inputs split by rows, and the leaves a decode step never reads
_BATCH_INPUTS = ("tokens", "frames", "img")
_DECODE_UNUSED = {"audio": ("encoder", "enc_lnf", "frontend_proj"),
                  "vlm": ("img_proj",)}


def _dp_entry(b: int, axes: Tuple[str, ...], mesh):
    """The spec entry of ``b`` batch rows over ``axes``, the axes they do
    not divide dropped from the right, as the rules' resolver drops them
    (every shard of a dropped axis holds the same rows)."""
    while axes and b % math.prod(mesh.shape[x] for x in axes):
        axes = axes[:-1]
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _data_parallel(bundle: ModelBundle, rules, mesh) -> ModelBundle:
    """``bundle`` data parallel on ``mesh``: the batch-dim inputs (tokens,
    frames, image patches) split by rows over the mesh axes the rules give
    "batch" (``_dp_entry``); every parameter gathered whole on each shard
    where its placement splits it (``respec``: the leaves a step reads,
    each once a step); the family's own one-device prefill and decode run
    on each shard's rows, shard after shard; the logits joined on the lead
    device and every cache leaf held by batch rows (``ShardedLeaf``), each
    shard's rows its own copy."""
    cfg = bundle.arch
    axes = tuple(x for x in _rule_axes(rules, "batch")
                 if x in mesh.axis_names)
    rows = {path: d.logical.index("batch") for path, d in tree_paths(
        bundle.cache_decls(ShapeConfig("mesh", 1, 1, "decode")))}
    n = len(mesh.devices)
    one_prefill, one_decode = bundle.prefill_fn, bundle.decode_fn

    def spec(t, dim: int, entry):
        out = [None] * t.dim()
        out[dim] = entry
        return tuple(out)

    def whole(params, skip=()):
        parts = tree_map(lambda t: replicated(t, mesh),
                         {k: v for k, v in params.items() if k not in skip})
        return [tree_map(lambda p: p[i], parts) for i in range(n)]

    def run(step, entry):
        outs = []
        for i, dev in enumerate(mesh.devices):
            with on_shard(dev):
                outs.append(step(i))
        logits = join_spec([o[0] for o in outs], (entry, None), mesh)
        held = [dict(tree_paths(o[1])) for o in outs]
        cache = tree_map_with_path(lambda path, t: ShardedLeaf(
            [h[path] for h in held], spec(t, rows[path], entry), mesh),
            outs[0][1])
        return logits, cache

    def prefill_fn(params, batch):
        entry = _dp_entry(batch["tokens"].shape[0], axes, mesh)
        inputs = {k: split_spec(v, spec(v, 0, entry), mesh)
                  for k, v in batch.items() if k in _BATCH_INPUTS}
        ws = whole(params)
        return run(lambda i: one_prefill(
            ws[i], {k: v[i] for k, v in inputs.items()}), entry)

    def decode_fn(params, cache, batch):
        entry = cache["cur"].spec[0]
        toks = split_spec(batch["tokens"], (entry, None), mesh)
        ws = whole(params, _DECODE_UNUSED.get(cfg.family, ()))
        return run(lambda i: one_decode(
            ws[i], tree_map(lambda leaf: leaf.parts[i], cache),
            {"tokens": toks[i]}), entry)

    def place(cache):
        entry = _dp_entry(cache["cur"].shape[0], axes, mesh)

        def one(path, t):
            s = spec(t, rows[path], entry)
            return ShardedLeaf([p.clone() for p in split_spec(t, s, mesh)],
                               s, mesh)
        return tree_map_with_path(one, cache)

    return replace(bundle, loss_fn=_no_training(cfg), prefill_fn=prefill_fn,
                   decode_fn=decode_fn, place_cache=place,
                   join_cache=partial(tree_map, lambda t: t.join()),
                   mesh=mesh)


# ---------------------------------------------------------------------------
_BUILDERS = {"dense": build_decoder, "moe": build_decoder,
             "ssm": build_xlstm, "hybrid": build_hybrid,
             "audio": build_encdec, "vlm": build_vlm}


def build_model(cfg: ArchConfig, rules=None, mesh=None,
                remat: str = "full", attn_chunk: int = 1024) -> ModelBundle:
    """The ModelBundle of an architecture, by its family; an unknown
    family raises ``NotImplementedError``.  ``rules`` (sharding/axes.py;
    by default ``rules_for`` the architecture) and ``mesh`` declare the
    reference's trees on that mesh: query heads padded to the "model"
    degree when the rules shard heads, routed experts padded to the
    expert axis.  ``remat`` is the training form's rematerialisation of
    the layer bodies (see ``_remat``)."""
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(
            f"unknown family {cfg.family!r} ({cfg.name}); known: "
            f"{sorted(_BUILDERS)}")
    if rules is None:
        rules = rules_for(cfg.name, "train", cfg.d_model)
    # the reference pads Q-heads to the TP degree when heads are
    # model-sharded (40 -> 48, 56 -> 64), for its partitioner
    if mesh is not None and rules.to_dict().get("heads") is not None:
        tp = mesh.shape.get("model", 1)
        a = cfg.attention
        if tp > 1 and a.n_heads % tp:
            pad = ((a.n_heads + tp - 1) // tp) * tp
            cfg = replace(cfg, attention=replace(a, n_heads=pad))
    bundle = _BUILDERS[cfg.family](cfg, rules, mesh=mesh, remat=remat,
                                   attn_chunk=attn_chunk)
    return replace(bundle, rules=rules)
