"""The port's encoder-decoder (whisper-base) and VLM (llama-3.2-vision-90b)
families — ``build_encdec``, ``build_vlm``, cross-attention — and the
engine's repairs for them, against the JAX package's, on the CPU.

Both packages get the same parameters: the reference draws them
(``init_tree`` with a JAX key) and ``params_from_numpy`` carries the tree
across bit for bit.  The VLM declares its cross-attention gates zero
(tanh(0) cancels the cross-attention), so they are drawn non-zero here
(0.5 and -0.7 for the two groups) on both sides.  Token ids, frames and
image patches come from numpy with a seed; in bf16 the frames and patches
are rounded to bf16 (their declared type) on both sides.  The models are
the reduced configs: whisper 2 encoder and 2 decoder layers (d 64, 4
heads of 32) over 48 frames against a 40-token prompt, so that the cross
keys have another length than the queries; the VLM 2 groups of one self-
and one cross-attention layer (GQA 4/4 after the cut, heads of 32) against
16 image tokens.  ``attn_chunk`` 32 makes the reference's attention run
its chunked scan with a ragged tail.

Tiers, as fractions of the reference's largest magnitude (those of
tests/test_torch_lm.py): float32 1e-4, bf16 as declared 0.08.  Greedy
tokens are equal in float32.  Whisper's decode adds the sinusoid of
position 0 at every step (the reference's behaviour, which its own
prefill/decode check leaves out), so its decode is held against the
reference's decode and not against a longer prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import init_tree as jax_init_tree
from repro.models import layers as JL
from repro.models.param import is_decl as jax_is_decl
from repro.models.param import param_count as jax_param_count
from repro.serving import engine as jax_engine
from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.param import param_count, tree_map, tree_paths
from repro_torch.serving import Engine, grow_cache

TIER = {"f32": 1e-4, "bf16": 0.08}
ARCHS = {"audio": "whisper-base", "vlm": "llama-3.2-vision-90b"}
SEQ = 40
FRAMES = 48
GATES = (0.5, -0.7)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


_CACHE = {}


def _models(family, dtype):
    """(reference bundle, its params, port bundle, port params), module
    wide; float32 is the bf16 draw cast."""
    key = (family, dtype)
    if key not in _CACHE:
        if dtype == "f32":
            jb, jp, pb, _ = _models(family, "bf16")
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        else:
            name = ARCHS[family]
            jb = jax_build_model(jax_get_arch(name, reduced=True),
                                 remat="none", attn_chunk=32)
            jp = jax_init_tree(jb.decls, jax.random.key(0))
            if family == "vlm":
                gate = np.asarray(GATES, np.float32)[:, None]
                jp["cross_layers"]["gate"] = jnp.asarray(gate)
            pb = build_model(get_arch(name, reduced=True), attn_chunk=32)
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[key] = (jb, jp, pb, pp)
    return _CACHE[key]


def _batch(family, dtype, b=2, s=SEQ, seed=1):
    """The prefill's inputs as numpy: tokens, and the frames (B, FRAMES,
    d_frontend) or image patches (B, n_img, d_frontend), rounded to bf16
    in bf16."""
    cfg = get_arch(ARCHS[family], reduced=True)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    n = FRAMES if family == "audio" else cfg.n_frontend_tokens
    x = rng.standard_normal((b, n, cfg.d_frontend), dtype=np.float32)
    if dtype == "bf16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    out["frames" if family == "audio" else "img"] = x
    return out


def _jax_batch(batch, dtype):
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v).astype(jt)
            for k, v in batch.items()}


def _torch_batch(batch, dtype):
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return {k: torch.from_numpy(v) if k == "tokens"
            else torch.from_numpy(v).to(tt) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _caches_match(tcache, jcache, dtype):
    assert sorted(tcache) == sorted(jcache)
    for path, leaf in tree_paths(tcache):
        want = _leaf(jcache, path)
        assert tuple(leaf.shape) == tuple(want.shape), path
        if leaf.dtype == torch.int32:
            assert np.array_equal(leaf.numpy(), np.asarray(want)), path
        else:
            assert _rel(_np(leaf), _np(want)) < TIER[dtype], path


# ---------------------------------------------------------------------------
# configs and declarations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(family, reduced):
    jc = jax_get_arch(ARCHS[family], reduced=reduced)
    pc = get_arch(ARCHS[family], reduced=reduced)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()


def _jax_decl_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jax_is_decl)
    return {tuple(k.key for k in path): (tuple(d.shape),
                                         np.dtype(d.dtype).name)
            for path, d in flat}


def _port_decl_paths(tree):
    return {path: (tuple(d.shape), str(d.dtype).replace("torch.", ""))
            for path, d in tree_paths(tree)}


@pytest.mark.parametrize("family", list(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(family, reduced):
    """Parameter, cache and input declarations (shapes, types), full and
    reduced: whisper's encoder, decoder and cross caches; the VLM's groups
    of self layers, its gated cross layers and its image-token cache."""
    jb = jax_build_model(jax_get_arch(ARCHS[family], reduced=reduced),
                         remat="none")
    pb = build_model(get_arch(ARCHS[family], reduced=reduced))
    assert _port_decl_paths(pb.decls) == _jax_decl_paths(jb.decls)
    assert param_count(pb.decls) == jax_param_count(jb.decls)
    for shape in (ShapeConfig("t", 64, 2, "train"),
                  ShapeConfig("p", 100, 2, "prefill"),
                  ShapeConfig("d", 4096, 3, "decode")):
        assert _port_decl_paths(pb.cache_decls(shape)) == \
            _jax_decl_paths(jb.cache_decls(shape))
        assert _port_decl_paths(pb.input_specs(shape)) == \
            _jax_decl_paths(jb.input_specs(shape))


# ---------------------------------------------------------------------------
# the layers: layer_norm, the sinusoid, cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_and_sinusoid_match_reference(dtype):
    rng = np.random.default_rng(0)
    jt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x, w, b = (rng.standard_normal(shape, dtype=np.float32) + 0.3
               for shape in ((2, 9, 48), (48,), (48,)))
    got = L.layer_norm(*(torch.from_numpy(a).to(tt) for a in (x, w, b)))
    want = JL.layer_norm(*(jnp.asarray(a).astype(jt) for a in (x, w, b)))
    assert got.dtype == tt
    assert _rel(_np(got), _np(want)) < TIER[dtype]
    for seq, d in ((1, 64), (1500, 512), (7, 30)):
        got = L.sinusoidal_pos(seq, d, tt)
        want = JL.sinusoidal_pos(seq, d, jt)
        assert got.dtype == tt and np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("skv", [16, 77])           # fewer keys; more keys
def test_cross_attention_matches_reference(dtype, skv):
    """attn_forward's kv_override branch (q from x, k and v from the other
    sequence, no rope, never causal) and attn_decode's cross branch (no
    write, every slot valid) against the reference's, layer by layer, on
    the VLM's cross layer, at Sq 40 against Skv 16 and 77."""
    jb, jp, pb, pp = _models("vlm", dtype)
    a = jb.arch.attention
    jl = jax.tree.map(lambda t: t[0], jp["cross_layers"]["attn"])
    tl = {k: v[0] for k, v in pp["cross_layers"]["attn"].items()}
    rng = np.random.default_rng(skv)
    x = rng.standard_normal((2, SEQ, jb.arch.d_model), dtype=np.float32)
    kv = rng.standard_normal((2, skv, jb.arch.d_model), dtype=np.float32)
    jx, jkv = (jnp.asarray(t).astype(jp["emb"].dtype) for t in (x, kv))
    tx, tkv = (torch.from_numpy(t).to(pp["emb"].dtype) for t in (x, kv))
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv))
    want, (jk, jv) = jax.jit(lambda p, x, pos, kv, kpos: JL.attn_forward(
        p, a, x, pos, jb.rules, use_rope=False, chunk=32,
        kv_override=(kv, kpos)))(jl, jx, jnp.asarray(pos), jkv,
                                 jnp.asarray(kpos))
    got, (tk, tv) = L.attn_forward(tl, a, tx, use_rope=False, chunk=32,
                                   kv_override=(tkv, None))
    assert tuple(tk.shape) == (2, skv, a.n_kv_heads, a.head_dim)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        assert _rel(_np(g), _np(w)) < TIER[dtype]
    cur = np.full((2,), SEQ, np.int32)
    slot_pos = np.full((2, SEQ + 3), -1, np.int32)
    jcache = {"k": jk, "v": jv}
    tcache = {"k": tk.clone(), "v": tv.clone()}
    want1, _ = jax.jit(lambda p, x, cur, sp, c: JL.attn_decode(
        p, a, x, cur, sp, c, jb.rules, use_rope=False, cross=True))(
        jl, jx[:, :1], jnp.asarray(cur), jnp.asarray(slot_pos), jcache)
    got1, back = L.attn_decode(tl, a, tx[:, :1], torch.from_numpy(cur),
                               torch.from_numpy(slot_pos), tcache,
                               use_rope=False, cross=True)
    assert _rel(_np(got1), _np(want1)) < TIER[dtype]
    assert torch.equal(back["k"], tk) and torch.equal(back["v"], tv)


def test_card_attention_route_takes_cross_attention():
    """The card's route (heads folded, the kernel's plain version on CPU
    tensors) with keys of their own length, non-causal and unwindowed,
    against the reference's attention_core with keys at arange(Skv);
    causal or windowed with Skv != Sq it raises."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, SEQ, 4, 32), dtype=np.float32)
    for skv in (16, 77):
        k, v = (rng.standard_normal((2, skv, 4, 32), dtype=np.float32)
                for _ in range(2))
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
        kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv))
        want = JL.attention_core(*map(jnp.asarray, (q, k, v, pos, kpos)),
                                 causal=False, window=None, chunk=32)
        got = L.flash_attention_heads(*map(torch.from_numpy, (q, k, v)),
                                      causal=False, window=None)
        assert _rel(_np(got), _np(want)) < TIER["f32"]
        for causal, window in ((True, None), (False, 8), (True, 8)):
            with pytest.raises(ValueError, match="arange"):
                L.flash_attention_heads(
                    *map(torch.from_numpy, (q, k, v)), causal=causal,
                    window=window)


# ---------------------------------------------------------------------------
# the models: prefill, decode, caches
# ---------------------------------------------------------------------------
_RUNS = {}


def _prefill_pair(family, dtype):
    key = (family, dtype)
    if key not in _RUNS:
        jb, jp, pb, pp = _models(family, dtype)
        batch = _batch(family, dtype)
        jl, jcache = jax.jit(jb.prefill_fn)(jp, _jax_batch(batch, dtype))
        with torch.inference_mode():
            tl, tcache = pb.prefill_fn(pp, _torch_batch(batch, dtype))
        _RUNS[key] = (jl, jcache, tl, tcache)
    return _RUNS[key]


@pytest.mark.parametrize("family", list(ARCHS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(family, dtype):
    """Logits and the cache: the self keys and values, the cross ones
    (whisper: the encoder's 48 frames; the VLM: 16 image tokens), the slot
    table and ``cur``."""
    jl, jcache, tl, tcache = _prefill_pair(family, dtype)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    assert _rel(_np(tl), _np(jl)) < TIER[dtype]
    if dtype == "f32":
        assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    assert set(tcache) == {"self_kv", "cross_kv", "slot_pos", "cur"}
    n_cross = FRAMES if family == "audio" else 16
    assert tcache["cross_kv"]["k"].shape[-3] == n_cross
    _caches_match(tcache, jcache, dtype)


@pytest.mark.parametrize("family", list(ARCHS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_teacher_forced_matches_reference(family, dtype):
    """Three decode steps after the prefill, grown by 4 with both engines'
    ``grow_cache`` (the cross cache keeps its length), both packages fed
    the reference's greedy tokens from their own prefill caches."""
    jb, jp, pb, pp = _models(family, dtype)
    jl, jcache, _, tcache = _prefill_pair(family, dtype)
    jcache = jax_engine.grow_cache(jb.arch, jcache, 4)
    tcache = grow_cache(pb.arch, tree_map(torch.clone, tcache), 4)
    dec = jax.jit(jb.decode_fn)
    logits = jl
    for _ in range(3):
        tok = np.asarray(jnp.argmax(logits, -1)[:, None]).astype(np.int32)
        logits, jcache = dec(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            got, tcache = pb.decode_fn(pp, tcache,
                                       {"tokens": torch.from_numpy(tok)})
        assert _rel(_np(got), _np(logits)) < TIER[dtype]
        if dtype == "f32":
            assert (_np(got).argmax(-1) == _np(logits).argmax(-1)).all()
        _caches_match(tcache, jcache, dtype)


@pytest.mark.parametrize("family", list(ARCHS))
def test_grow_cache_leaves_the_cross_cache_as_the_reference(family):
    """grow_cache pads the self keys and values and the slot table, and
    leaves ``cross_kv`` as it is: a cross decode attends to every slot, so
    zero rows added there would take softmax weight."""
    jb, _, pb, _ = _models(family, "f32")
    _, jcache, _, tcache = _prefill_pair(family, "f32")
    jg = jax_engine.grow_cache(jb.arch, jcache, 6)
    tg = grow_cache(pb.arch, tcache, 6)
    assert tg["cross_kv"]["k"] is tcache["cross_kv"]["k"]
    assert tg["self_kv"]["k"].shape[-3] == SEQ + 6
    assert tg["slot_pos"].shape[-1] == SEQ + 6
    _caches_match(tg, jg, "f32")


@pytest.mark.parametrize("family", list(ARCHS))
def test_engine_generate_matches_reference(family):
    """Engine.generate with ``frames`` or ``img`` in the batch through both
    engines from the same float32 parameters: the prefill gets the whole
    batch, decode the keys beside the tokens, and the greedy tokens are
    the same."""
    jb, jp, pb, pp = _models(family, "f32")
    batch = _batch(family, "f32", s=30, seed=3)
    jr = jax_engine.Engine(jb, jp).generate(_jax_batch(batch, "f32"),
                                            n_gen=5)
    tr = Engine(pb, pp, device="cpu").generate(batch, n_gen=5)
    assert tr.tokens.shape == (2, 5)
    assert np.array_equal(tr.tokens, jr.tokens)


def test_vlm_gate_scales_the_cross_attention():
    """tanh(gate) multiplies the cross-attention out: with the gates at
    zero (as declared) the image does not move the logits, with them
    drawn it does."""
    _, _, pb, pp = _models("vlm", "f32")
    batch = _torch_batch(_batch("vlm", "f32"), "f32")
    other = dict(batch, img=batch["img"] * 2.0 + 1.0)
    zero = dict(pp, cross_layers={**pp["cross_layers"],
                                  "gate": torch.zeros_like(
                                      pp["cross_layers"]["gate"])})
    with torch.inference_mode():
        a0, _ = pb.prefill_fn(zero, batch)
        b0, _ = pb.prefill_fn(zero, other)
        a1, _ = pb.prefill_fn(pp, batch)
        b1, _ = pb.prefill_fn(pp, other)
    assert torch.equal(a0, b0)
    assert not torch.allclose(a1, b1)


def test_whisper_decode_adds_the_position_zero_sinusoid():
    """The reference's decode adds sinusoidal_pos(1) — position 0 — at
    every step, not the token's position; the port does the same: a decode
    step's logits depend on the token and the cache only, not on ``cur``
    through the sinusoid (the self keys are not rotated)."""
    _, _, pb, pp = _models("audio", "f32")
    _, _, _, tcache = _prefill_pair("audio", "f32")
    tok = torch.tensor([[5], [7]], dtype=torch.int32)
    got = []
    for shift in (0, 3):
        cache = grow_cache(pb.arch, tree_map(torch.clone, tcache), 4)
        cache["cur"] += shift
        with torch.inference_mode():
            logits, _ = pb.decode_fn(pp, cache, {"tokens": tok})
        got.append(logits)
    assert torch.allclose(got[0], got[1], rtol=1e-5, atol=1e-5)


def test_prefill_launches_no_kernel_on_the_cpu():
    runtime.reset_launch_counts()
    for family in ARCHS:
        _, _, pb, pp = _models(family, "bf16")
        with torch.inference_mode():
            logits, _ = pb.prefill_fn(pp, _torch_batch(_batch(family, "bf16"),
                                                       "bf16"))
        assert torch.isfinite(logits).all()
    assert set(runtime.launch_counts.values()) == {0}
