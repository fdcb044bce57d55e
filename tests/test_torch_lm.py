"""The port's LM serving path (the hybrid family, zamba2) against the JAX
package's, on the CPU.

Both packages get the same parameters: the reference draws them
(``init_tree`` with a JAX key) and ``params_from_numpy`` carries them
across bit for bit.  Token ids and activations come from numpy with a
seed.  The model is the reduced zamba2 (d 64, 6 slots: 2 groups of 2
Mamba2 blocks and the shared block; window 64, SSD chunk 16), also with a
seventh slot so that a tail Mamba2 block runs, at S 100 > window and not a
multiple of the chunk.

Tiers, stated as fractions of the reference's largest magnitude:
* float32 — parameters cast to float32 on both sides: 1e-4 (measured
  about 2e-6: the two sum in different orders);
* bf16 as declared: 0.08 (measured up to 0.035: XLA on the CPU keeps some
  bf16 intermediates in float32 where PyTorch rounds them).
Integer caches (slot tables, positions) must be exact, and the greedy
tokens equal.
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
from repro.models import ssm as JS
from repro.models.param import is_decl as jax_is_decl
from repro.serving import engine as jax_engine
from repro_torch import runtime
from repro_torch.configs import NOT_PORTED, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model, init_tree, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.param import (
    cast_floating, param_count, tree_leaves, tree_map, tree_paths,
)
from repro_torch.serving import Engine, grow_cache, init_cache

TIER = {"f32": 1e-4, "bf16": 0.08}
SEQ = 100


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _cfgs(tail: bool):
    jc = jax_get_arch("zamba2-7b", reduced=True)
    pc = get_arch("zamba2-7b", reduced=True)
    if tail:
        jc, pc = (dataclasses.replace(c, n_layers=7) for c in (jc, pc))
    return jc, pc


_CACHE = {}


def _models(dtype: str, tail: bool = False, attn_chunk: int = 32):
    """(reference bundle, its params, port bundle, port params)."""
    key = (dtype, tail, attn_chunk)
    if key not in _CACHE:
        jc, pc = _cfgs(tail)
        jb = jax_build_model(jc, remat="none", attn_chunk=attn_chunk)
        jp = jax_init_tree(jb.decls, jax.random.key(0))
        if dtype == "f32":
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        pb = build_model(pc, attn_chunk=attn_chunk)
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[key] = (jb, jp, pb, pp)
    return _CACHE[key]


def _tokens(b=2, s=SEQ, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# configs, declarations, the carry-across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    jc = jax_get_arch("zamba2-7b", reduced=reduced)
    pc = get_arch("zamba2-7b", reduced=reduced)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()
    if not reduced:
        assert pc.param_count() == 5_740_529_536


def test_unported_archs_and_families_raise():
    for name in NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP item 15"):
            get_arch(name)
    with pytest.raises(KeyError, match="unknown"):
        get_arch("no-such-arch")
    dense = dataclasses.replace(get_arch("zamba2-7b", reduced=True),
                                family="dense")
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        build_model(dense)


def _jax_decl_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jax_is_decl)
    return {tuple(k.key for k in path): (tuple(d.shape), np.dtype(d.dtype).name)
            for path, d in flat}


def _port_decl_paths(tree):
    return {path: (tuple(d.shape), str(d.dtype).replace("torch.", ""))
            for path, d in tree_paths(tree)}


@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(reduced):
    jb = jax_build_model(jax_get_arch("zamba2-7b", reduced=reduced),
                         remat="none")
    pb = build_model(get_arch("zamba2-7b", reduced=reduced))
    assert _port_decl_paths(pb.decls) == _jax_decl_paths(jb.decls)
    from repro.models.param import param_count as jax_param_count
    assert param_count(pb.decls) == jax_param_count(jb.decls)
    for shape in (ShapeConfig("p", 100, 2, "prefill"),
                  ShapeConfig("d", 32768, 3, "decode")):
        assert _port_decl_paths(pb.cache_decls(shape)) == \
            _jax_decl_paths(jb.cache_decls(shape))
        assert _port_decl_paths(pb.input_specs(shape)) == \
            _jax_decl_paths(jb.input_specs(shape))


def test_params_from_numpy_is_bitwise():
    jb, jp, _, pp = _models("bf16")
    want = jax.tree.map(np.asarray, jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    got = dict(tree_paths(pp))
    assert len(got) == len(flat)
    dtypes = set()
    for path, a in flat:
        t = got[tuple(k.key for k in path)]
        dtypes.add(a.dtype.name)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)
    assert dtypes == {"bfloat16", "float32"}
    ints = params_from_numpy({"a": np.arange(6, dtype=np.int32)}, "cpu")
    assert ints["a"].dtype == torch.int32
    assert np.array_equal(ints["a"].numpy(), np.arange(6))


def test_init_tree_is_seeded_and_follows_the_decls():
    pb = build_model(get_arch("zamba2-7b", reduced=True))
    a = init_tree(pb.decls, torch.Generator().manual_seed(3), "cpu")
    b = init_tree(pb.decls, torch.Generator().manual_seed(3), "cpu")
    c = init_tree(pb.decls, torch.Generator().manual_seed(4), "cpu")
    for (path, d), ta, tb, tc in zip(tree_paths(pb.decls), tree_leaves(a),
                                     tree_leaves(b), tree_leaves(c)):
        assert tuple(ta.shape) == d.shape and ta.dtype == d.dtype, path
        assert torch.equal(ta, tb), path
        if d.init == "zeros":
            assert not ta.any(), path
        elif d.init == "ones":
            assert (ta == 1).all(), path
        else:
            assert not torch.equal(ta, tc), path


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_rope_mlp_match_reference(dtype):
    rng = np.random.default_rng(0)
    jt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32)
    jx, tx = jnp.asarray(x).astype(jt), torch.from_numpy(x).to(tt)
    jw, tw = jnp.asarray(w).astype(jt), torch.from_numpy(w).to(tt)
    assert _rel(_np(L.rms_norm(tx, tw)), _np(JL.rms_norm(jx, jw))) \
        < TIER[dtype]
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + 5
    assert _rel(_np(L.apply_rope(tx, torch.from_numpy(pos), 1e4)),
                _np(JL.apply_rope(jx, jnp.asarray(pos), 1e4))) < TIER[dtype]
    wi = rng.standard_normal((32, 2, 48), dtype=np.float32) / 6
    wo = rng.standard_normal((48, 32), dtype=np.float32) / 7
    jm = {"wi": jnp.asarray(wi).astype(jt), "wo": jnp.asarray(wo).astype(jt)}
    tm = {"wi": torch.from_numpy(wi).to(tt), "wo": torch.from_numpy(wo).to(tt)}
    got = L.mlp_forward(tm, tx, "silu", True)
    want = JL.mlp_forward(jm, jx, "silu", True, _models("f32")[0].rules)
    assert _rel(_np(got), _np(want)) < TIER[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attn_chunk", [32, 128])   # chunked; dense branch
def test_attn_forward_matches_reference(dtype, attn_chunk):
    jb, jp, pb, pp = _models(dtype)
    cfg = jb.arch
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, SEQ, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (2, SEQ))
    jx = jnp.asarray(x).astype(jp["emb"].dtype)
    tx = torch.from_numpy(x).to(pp["emb"].dtype)
    want, (jk, jv) = JL.attn_forward(jp["shared"]["attn"], cfg.attention, jx,
                                     jnp.asarray(pos), jb.rules,
                                     chunk=attn_chunk)
    got, (tk, tv) = L.attn_forward(pp["shared"]["attn"], cfg.attention, tx,
                                   torch.from_numpy(pos.copy()),
                                   chunk=attn_chunk)
    assert _rel(_np(got), _np(want)) < TIER[dtype]
    assert _rel(_np(tk), _np(jk)) < TIER[dtype]
    assert _rel(_np(tv), _np(jv)) < TIER[dtype]


def test_attn_forward_default_positions_are_arange():
    """positions=None (what the prefill passes, and the only form the card
    route takes) is arange(S) in every row, bit for bit."""
    _, _, pb, pp = _models("f32")
    cfg = pb.arch
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model),
                                             dtype=np.float32))
    pos = torch.arange(SEQ, dtype=torch.int32).expand(2, SEQ)
    got, (gk, gv) = L.attn_forward(pp["shared"]["attn"], cfg.attention, x)
    want, (wk, wv) = L.attn_forward(pp["shared"]["attn"], cfg.attention, x,
                                    pos)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,chunk", [(SEQ, 16), (64, 16), (37, 64)])
def test_ssd_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    xb = rng.standard_normal((2, s, 3, 8), dtype=np.float32)
    la = (-rng.random((2, s, 3)) * 2).astype(np.float32)
    bm = rng.standard_normal((2, s, 4), dtype=np.float32)
    cm = rng.standard_normal((2, s, 4), dtype=np.float32)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (xb, la, bm, cm)), chunk)
    ty, ts = S.ssd_chunked(*map(torch.from_numpy, (xb, la, bm, cm)), chunk)
    assert _rel(_np(ty), _np(jy)) < TIER["f32"]
    assert _rel(_np(ts), _np(js)) < TIER["f32"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_forward_matches_reference(dtype):
    jb, jp, pb, pp = _models(dtype)
    cfg = jb.arch
    x = np.random.default_rng(3).standard_normal((2, SEQ, cfg.d_model),
                                                 dtype=np.float32)
    jl = jax.tree.map(lambda a: a[1, 0], jp["mamba"])
    tl = {k: v[1, 0] for k, v in pp["mamba"].items()}
    jx = jnp.asarray(x).astype(jp["emb"].dtype)
    tx = torch.from_numpy(x).to(pp["emb"].dtype)
    want, (js, jconv) = JS.mamba2_forward(jl, cfg, jx, jb.rules,
                                          return_state=True)
    got, (ts, tconv) = S.mamba2_forward(tl, cfg, tx, return_state=True)
    assert _rel(_np(got), _np(want)) < TIER[dtype]
    assert _rel(_np(ts), _np(js)) < TIER[dtype]
    assert _rel(_np(tconv), _np(jconv)) < TIER[dtype]
    # one decode step from that state
    x1 = x[:, :1]
    jst = {"ssm": js, "conv": jconv}
    tst = {"ssm": ts, "conv": tconv}
    want1, jst = JS.mamba2_decode(jl, cfg, jnp.asarray(x1).astype(jx.dtype),
                                  jst, jb.rules)
    got1, tst = S.mamba2_decode(tl, cfg, torch.from_numpy(x1).to(tx.dtype),
                                tst)
    assert _rel(_np(got1), _np(want1)) < TIER[dtype]
    assert _rel(_np(tst["ssm"]), _np(jst["ssm"])) < TIER[dtype]


# ---------------------------------------------------------------------------
# the model: prefill, decode, caches
# ---------------------------------------------------------------------------
_RUNS = {}


def _prefill_pair(dtype, tail, attn_chunk=32):
    key = (dtype, tail, attn_chunk)
    if key not in _RUNS:
        jb, jp, pb, pp = _models(dtype, tail, attn_chunk)
        toks = _tokens()
        jl, jcache = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(toks)})
        with torch.inference_mode():
            tl, tcache = pb.prefill_fn(pp, {"tokens": torch.from_numpy(toks)})
        _RUNS[key] = (jl, jcache, tl, tcache)
    return _RUNS[key]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tail", [False, True])
def test_prefill_matches_reference(dtype, tail):
    jl, jcache, tl, tcache = _prefill_pair(dtype, tail)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    assert _rel(_np(tl), _np(jl)) < TIER[dtype]
    assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    names = ["m_ssm", "m_conv"] + (["t_ssm", "t_conv"] if tail else [])
    assert sorted(tcache) == sorted(jcache)
    for name in names:
        assert _rel(_np(tcache[name]), _np(jcache[name])) < TIER[dtype], name
    for name in ("k", "v"):
        assert _rel(_np(tcache["shared_kv"][name]),
                    _np(jcache["shared_kv"][name])) < TIER[dtype], name
    for name in ("slot_pos", "cur"):
        assert tcache[name].dtype == torch.int32
        assert np.array_equal(tcache[name].numpy(), np.asarray(jcache[name]))


@pytest.mark.parametrize("attn_chunk", [32, 1024])
def test_prefill_attention_chunk_does_not_change_the_model(attn_chunk):
    """attn_chunk below S (the chunked online softmax, ragged tail) and
    above it (the dense branch), against the reference at the same
    setting, in float32."""
    jl, _, tl, _ = _prefill_pair("f32", False, attn_chunk)
    assert _rel(_np(tl), _np(jl)) < TIER["f32"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tail", [False, True])
def test_decode_teacher_forced_matches_reference(dtype, tail):
    """Two decode steps after the prefill, both packages fed the
    reference's greedy tokens, from the port's own prefill cache."""
    jb, jp, pb, pp = _models(dtype, tail)
    jl, jcache, tl, tcache = _prefill_pair(dtype, tail)
    jcache = jax_engine.grow_cache(jb.arch, jcache, 4)
    # decode writes into its cache: work on a copy of the shared prefill's
    tcache = grow_cache(pb.arch, tree_map(torch.clone, tcache), 4)
    dec = jax.jit(jb.decode_fn)
    logits = jl
    for _ in range(2):
        tok = np.asarray(jnp.argmax(logits, -1)[:, None]).astype(np.int32)
        logits, jcache = dec(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            got, tcache = pb.decode_fn(pp, tcache,
                                       {"tokens": torch.from_numpy(tok)})
        assert _rel(_np(got), _np(logits)) < TIER[dtype]
        assert (_np(got).argmax(-1) == _np(logits).argmax(-1)).all()
        for name in ("slot_pos", "cur"):
            assert np.array_equal(tcache[name].numpy(),
                                  np.asarray(jcache[name]))
        assert _rel(_np(tcache["m_ssm"]), _np(jcache["m_ssm"])) < TIER[dtype]
        assert _rel(_np(tcache["shared_kv"]["k"]),
                    _np(jcache["shared_kv"]["k"])) < TIER[dtype]


def test_init_cache_and_decode_from_empty_match_reference():
    jb, jp, pb, pp = _models("f32")
    shape = ShapeConfig("d", 8, 2, "decode")
    jcache = jax_engine.init_cache(jb, shape)
    tcache = cast_floating(init_cache(pb, shape, device="cpu"),
                           torch.float32)
    for path, leaf in tree_paths(tcache):
        want = jcache
        for k in path:
            want = want[k]
        if leaf.dtype == torch.int32:
            assert np.array_equal(leaf.numpy(), np.asarray(want)), path
        else:
            assert not leaf.any() and leaf.shape == want.shape, path
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, jcache)
    dec = jax.jit(jb.decode_fn)
    for step in range(3):
        tok = _tokens(2, 1, seed=10 + step)
        want, jcache = dec(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            got, tcache = pb.decode_fn(pp, tcache,
                                       {"tokens": torch.from_numpy(tok)})
        assert _rel(_np(got), _np(want)) < TIER["f32"]
        assert np.array_equal(tcache["slot_pos"].numpy(),
                              np.asarray(jcache["slot_pos"]))


@pytest.mark.parametrize("n_extra", [4, 100])      # below / past the window
def test_grow_cache_matches_reference(n_extra):
    jb, jp, pb, pp = _models("f32")
    toks = _tokens(2, 40)
    _, jcache = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        _, tcache = pb.prefill_fn(pp, {"tokens": torch.from_numpy(toks)})
    jg = jax_engine.grow_cache(jb.arch, jcache, n_extra)
    tg = grow_cache(pb.arch, tcache, n_extra)
    assert tg["slot_pos"].shape[-1] == min(40 + n_extra, 64)
    for path, leaf in tree_paths(tg):
        want = jg
        for k in path:
            want = want[k]
        assert tuple(leaf.shape) == tuple(want.shape), path
        if leaf.dtype == torch.int32:
            assert np.array_equal(leaf.numpy(), np.asarray(want)), path
        else:
            assert _rel(_np(leaf), _np(want)) < TIER["f32"], path


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_engine_generate_and_serve_match_reference_on_the_cpu():
    """Greedy generation through both engines from the same float32
    parameters gives the same tokens; serve_requests pads, batches and
    refills slots as the reference does."""
    jb, jp, pb, pp = _models("f32")
    jeng = jax_engine.Engine(jb, jp)
    teng = Engine(pb, pp, device="cpu")
    toks = _tokens(2, 70)
    jr = jeng.generate({"tokens": jnp.asarray(toks)}, n_gen=5)
    tr = teng.generate({"tokens": toks}, n_gen=5)
    assert tr.tokens.shape == (2, 5)
    assert np.array_equal(tr.tokens, jr.tokens)
    assert tr.prefill_s > 0 and tr.decode_s > 0 and tr.tokens_per_s > 0
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (10, 70, 33, 5, 90)]
    want = jeng.serve_requests(prompts, batch_size=2, prompt_len=64, n_gen=3)
    got = teng.serve_requests(prompts, batch_size=2, prompt_len=64, n_gen=3)
    assert len(got) == 5 and len(teng.last_results) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_decode_consistency_of_the_port(dtype):
    """The reference's own check on the port: the greedy token of
    prefill(prompt), decoded from the cache, against prefill(prompt +
    token) — logits within the hybrid tier 0.10 and the same argmax.  In
    bf16 the logits come out of a bf16 product, so two of them can tie at
    bf16 resolution: where the argmaxes differ, one side must rate the
    other's pick within one bf16 step of its own maximum (this prompt's
    second row: the decode rates tokens 31 and 75 both 2.546875, the
    prefill 2.546875 and 2.578125)."""
    _, _, pb, pp = _models(dtype)
    prompt = torch.from_numpy(_tokens(2, 32, seed=4))
    with torch.inference_mode():
        logits1, cache = pb.prefill_fn(pp, {"tokens": prompt})
        cache = grow_cache(pb.arch, cache, 4)
        tok = torch.argmax(logits1, -1)[:, None].to(torch.int32)
        logits2, _ = pb.decode_fn(pp, cache, {"tokens": tok})
        logits3, _ = pb.prefill_fn(pp, {"tokens": torch.cat([prompt, tok],
                                                            1)})
    a, b = logits2.numpy(), logits3.numpy()
    assert np.abs(a - b).max() / max(np.abs(b).max(), 1.0) < 0.10
    same = a.argmax(-1) == b.argmax(-1)
    if dtype == "f32":
        assert same.all()
    else:
        rows = np.arange(b.shape[0])

        def tie(x, other):      # other's pick within one bf16 step of x's top
            top = x.max(-1)
            step = 2.0 ** (np.floor(np.log2(np.abs(top))) - 7)
            return top - x[rows, other.argmax(-1)] <= step

        assert (same | tie(a, b) | tie(b, a)).all()
        assert same.any()


def test_engine_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    _, _, pb, pp = _models("f32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(pb, pp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(pb, ShapeConfig("d", 8, 2, "decode"))
    with pytest.raises(ValueError, match="params lie on"):
        Engine(pb, pp, device="meta")


def test_prefill_launches_no_kernel_on_the_cpu():
    _, _, pb, pp = _models("bf16", tail=True)
    runtime.reset_launch_counts()
    with torch.inference_mode():
        logits, _ = pb.prefill_fn(pp, {"tokens": torch.from_numpy(_tokens())})
    assert torch.isfinite(logits).all()
    assert set(runtime.launch_counts.values()) == {0}
