"""Model assembly of the port: an architecture becomes a ModelBundle with

* ``decls``                             — PDecl tree (params)
* ``prefill_fn(params, batch)``         -> (logits_last, cache)
* ``decode_fn(params, cache, batch)``   -> (logits, cache)
* ``cache_decls(shape)``                — PDecl tree of the decode cache
* ``input_specs(shape)``                — PDecl tree of the inputs

Ported, for serving: the decoder-only builder with its three families —
dense (GQA, sliding window, QKV bias), MoE (routed and shared experts,
with deepseek's leading dense layers) and MLA (deepseek-v2-lite's latent
attention) — and the hybrid (zamba2) family.  Stacked layers run as
Python loops over the stacked leading axes (the port has no scan), on
whichever device the parameters lie: on the card the prefill's attention
and SSD scans go through the hand-written kernels (see ``layers`` and
``ssm``).  ``decode_fn`` updates the cache it is given in place, where the
reference donates it.  The MoE aux loss is returned by the decoder's
backbone only: training (the loss, its backward) is not ported yet, nor
are the xLSTM, audio and VLM families (ROADMAP item 15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    attn_decls, attn_decode, attn_forward, mlp_decls, mlp_forward, rms_norm,
)
from repro_torch.models.moe import moe_decls, moe_forward
from repro_torch.models.param import PDecl, tree_map

F32 = torch.float32
I32 = torch.int32


def stack_decls(tree, n: int):
    return tree_map(
        lambda p: PDecl((n,) + p.shape, ("layers",) + p.logical,
                        p.dtype, p.init, p.scale), tree)


def _index(tree, *idx):
    """One layer's parameters (views) out of a stacked tree."""
    return {k: (_index(v, *idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


@dataclass
class ModelBundle:
    arch: ArchConfig
    decls: Any
    prefill_fn: Callable
    decode_fn: Callable
    cache_decls: Callable          # (ShapeConfig) -> PDecl tree
    input_specs: Callable          # (ShapeConfig) -> dict of PDecl


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
    return params["emb"][tokens.long()]


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


def _token_specs(shape: ShapeConfig):
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    return {"tokens": PDecl((b, s), ("batch", None), dtype=I32)}


# ---------------------------------------------------------------------------
# decoder-only: the dense and MoE families (GQA, SWA, QKV bias, MLA)
# ---------------------------------------------------------------------------
def build_decoder(cfg: ArchConfig, attn_chunk: int = 1024) -> ModelBundle:
    """The reference's ``build_decoder`` on one card (an expert axis of
    1): ``layers`` stacked n_layers - first_dense_layers deep, deepseek's
    leading dense layers stacked under ``head_layers``."""
    is_moe = cfg.family == "moe"
    ep = 1
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
            return moe_forward(lp["moe"], cfg, x, ep=ep)
        return mlp_forward(lp["mlp"], x, cfg.act, cfg.glu), None

    def layer(lp, h):                 # queries at arange(S): positions None
        a, kv = attn_forward(lp["attn"], cfg.attention,
                             rms_norm(h, lp["ln1"], cfg.norm_eps),
                             chunk=attn_chunk)
        h = h + a
        m, aux = ffn(lp, h)
        return h + m, kv, aux

    # (stacked params and cache key, depth) in the order they run
    stacks = ([("head_layers", n_dense_head)] if n_dense_head else []) \
        + [("layers", n_scan)]

    def backbone(params, tokens):
        """(h, the MoE aux loss, {stack: its layers' cache pairs, stacked})."""
        h = _embed(params, tokens)
        aux_total = torch.zeros((), dtype=F32, device=h.device)
        kvs = {}
        for name, depth in stacks:
            got = []
            for i in range(depth):
                h, kv, aux = layer(_index(params[name], i), h)
                if aux is not None:
                    aux_total = aux_total + aux
                got.append(kv)
            kvs[name] = tuple(torch.stack(t) for t in zip(*got))
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        return h, aux_total, kvs

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
        cache["slot_pos"] = torch.arange(s, dtype=I32, device=tokens.device) \
            .repeat(b, 1)
        cache["cur"] = torch.full((b,), s, dtype=I32, device=tokens.device)
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

    return ModelBundle(cfg, decls, prefill_fn, decode_fn, cache_decls,
                       _token_specs)


# ---------------------------------------------------------------------------
# zamba2 hybrid: groups of (shared_attn_every-1 mamba + shared block)
# ---------------------------------------------------------------------------
def build_hybrid(cfg: ArchConfig, attn_chunk: int = 1024) -> ModelBundle:
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
        h = h + a
        m = mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                        cfg.act, cfg.glu)
        return h + m, kv

    def backbone(params, tokens, collect=False):
        h = _embed(params, tokens)
        m_ssm, m_conv, ks, vs = [], [], [], []
        for g in range(n_groups):
            for i in range(n_m):
                out = S.mamba2_forward(_index(params["mamba"], g, i), cfg, h,
                                       return_state=collect)
                if collect:
                    h, (s_fin, conv_state) = out
                    m_ssm.append(s_fin)
                    m_conv.append(conv_state)
                else:
                    h = out
            h, (k, v) = shared_block(h, params)
            if collect:
                ks.append(k)
                vs.append(v)
        t_ssm, t_conv = [], []
        for i in range(n_tail):
            out = S.mamba2_forward(_index(params["tail"], i), cfg, h,
                                   return_state=collect)
            if collect:
                h, (s_fin, conv_state) = out
                t_ssm.append(s_fin)
                t_conv.append(conv_state)
            else:
                h = out
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        if not collect:
            return h, None

        def stack(xs, *lead):
            return torch.stack(xs).reshape(*lead, *xs[0].shape)

        states = {
            "m_ssm": stack(m_ssm, n_groups, n_m),
            "m_conv": stack(m_conv, n_groups, n_m),
            "k": torch.stack(ks), "v": torch.stack(vs),
        }
        if n_tail:
            states["t_ssm"] = torch.stack(t_ssm)
            states["t_conv"] = torch.stack(t_conv)
        return h, states

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
            "slot_pos": torch.arange(s - cap, s, dtype=I32,
                                     device=tokens.device)
            .repeat(b, 1),
            "cur": torch.full((b,), s, dtype=I32, device=tokens.device),
        }
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
            h = h + a
            m = mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"], cfg.norm_eps),
                            cfg.act, cfg.glu)
            h = h + m
        for i in range(n_tail):
            h = mamba_step(h, _index(params["tail"], i),
                           cache["t_ssm"][i], cache["t_conv"][i])
        h = rms_norm(h, params["lnf"], cfg.norm_eps)
        logits = _last_logits(_unemb(params, cfg), h)
        out = dict(cache)
        out["slot_pos"] = slot_pos
        out["cur"] = cur + 1
        return logits, out

    return ModelBundle(cfg, decls, prefill_fn, decode_fn, cache_decls,
                       _token_specs)


# ---------------------------------------------------------------------------
_BUILDERS = {"dense": build_decoder, "moe": build_decoder,
             "hybrid": build_hybrid}


def build_model(cfg: ArchConfig, attn_chunk: int = 1024) -> ModelBundle:
    """The ModelBundle of an architecture: the dense, MoE and hybrid
    families are ported; the others raise ``NotImplementedError``."""
    if cfg.family not in _BUILDERS:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP item 15); ported: {sorted(_BUILDERS)}")
    return _BUILDERS[cfg.family](cfg, attn_chunk=attn_chunk)
