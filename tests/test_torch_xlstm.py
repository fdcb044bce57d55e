"""The port's xLSTM family (``build_xlstm``: mLSTM blocks through the SSD
scan, the sequential sLSTM) against the JAX package's, on the CPU.

Both packages get the same parameters: the reference draws them
(``init_tree`` with a JAX key) and ``params_from_numpy`` carries the tree
across bit for bit.  Token ids and activations come from numpy with a
seed.  The reference's reduced xlstm-350m keeps slstm_every 8 at 4
layers, so it has no block at all; the models here are that config with
``dataclasses.replace`` on both sides (d 64, 4 heads, the mLSTM's key
depth 32 and value depth 32 + 1, chunk 16, the sLSTM's heads of 16):
* "pairs" — slstm_every 2: two groups, each one mLSTM and one sLSTM;
* "stack" — slstm_every 4: one group of three mLSTM and one sLSTM, so
  that a group's mLSTM stack has more than one layer.
The prompt (S 100) is not a multiple of the chunk.

Tiers, as fractions of the reference's largest magnitude (those of
tests/test_torch_lm.py): float32 1e-4, bf16 as declared 0.08.  Greedy
tokens are equal in float32.
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
from repro.models import ssm as JS
from repro.models.param import is_decl as jax_is_decl
from repro.models.param import param_count as jax_param_count
from repro.serving import engine as jax_engine
from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as S
from repro_torch.models.param import param_count, tree_map, tree_paths
from repro_torch.serving import Engine, grow_cache, init_cache

TIER = {"f32": 1e-4, "bf16": 0.08}
SEQ = 100
VARIANTS = {"pairs": 2, "stack": 4}      # name -> slstm_every


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _cfgs(variant):
    every = VARIANTS[variant]
    return tuple(dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, slstm_every=every))
        for c in (jax_get_arch("xlstm-350m", reduced=True),
                  get_arch("xlstm-350m", reduced=True)))


_CACHE = {}


def _models(variant, dtype):
    """(reference bundle, its params, port bundle, port params), module
    wide; float32 is the bf16 draw cast."""
    key = (variant, dtype)
    if key not in _CACHE:
        if dtype == "f32":
            jb, jp, pb, _ = _models(variant, "bf16")
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        else:
            jc, pc = _cfgs(variant)
            jb = jax_build_model(jc, remat="none", attn_chunk=32)
            jp = jax_init_tree(jb.decls, jax.random.key(0))
            pb = build_model(pc, attn_chunk=32)
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[key] = (jb, jp, pb, pp)
    return _CACHE[key]


def _tokens(b=2, s=SEQ, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)) \
        .astype(np.int32)


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
# config and declarations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    jc = jax_get_arch("xlstm-350m", reduced=reduced)
    pc = get_arch("xlstm-350m", reduced=reduced)
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


@pytest.mark.parametrize("which", ["full", "reduced", "pairs", "stack"])
def test_decls_match_reference(which):
    """Parameter, cache and input declarations (shapes, types): the full
    model (3 groups of 7 mLSTM and an sLSTM), the reference's reduced one
    (no group) and the two variants."""
    if which in VARIANTS:
        jc, pc = _cfgs(which)
    else:
        jc = jax_get_arch("xlstm-350m", reduced=which == "reduced")
        pc = get_arch("xlstm-350m", reduced=which == "reduced")
    jb = jax_build_model(jc, remat="none")
    pb = build_model(pc)
    assert _port_decl_paths(pb.decls) == _jax_decl_paths(jb.decls)
    assert param_count(pb.decls) == jax_param_count(jb.decls)
    for shape in (ShapeConfig("p", 100, 2, "prefill"),
                  ShapeConfig("d", 4096, 3, "decode")):
        assert _port_decl_paths(pb.cache_decls(shape)) == \
            _jax_decl_paths(jb.cache_decls(shape))
        assert _port_decl_paths(pb.input_specs(shape)) == \
            _jax_decl_paths(jb.input_specs(shape))


def test_full_model_runs_k6_at_n512_p513():
    """xlstm-350m's mLSTM: 4 heads of 512, so its SSD lanes have a state
    of 512 keys by 513 values (the normalizer column), 21 mLSTM and 3
    sLSTM blocks."""
    cfg = get_arch("xlstm-350m")
    bundle = build_model(cfg)
    m = bundle.decls["mlstm"]
    assert m["wq"].shape == (3, 7, 2048, 2048)
    assert bundle.decls["slstm"]["r"].shape == (3, 4, 256, 1024)
    shape = ShapeConfig("p", 2048, 4, "prefill")
    assert bundle.cache_decls(shape)["m_ssm"].shape == (3, 7, 4, 4, 512, 513)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_forward_and_decode_match_reference(dtype):
    """One mLSTM block (gates drawn non-zero) over S 100, its final SSD
    state and conv window, and two decode steps from them."""
    jb, jp, pb, pp = _models("stack", dtype)
    cfg = jb.arch
    rng = np.random.default_rng(3)
    jl = jax.tree.map(lambda a: a[0, 1], jp["mlstm"])
    bgate = rng.standard_normal(jl["bgate"].shape, dtype=np.float32)
    jl = {**jl, "bgate": jnp.asarray(bgate)}
    tl = {k: v[0, 1] for k, v in pp["mlstm"].items()}
    tl["bgate"] = torch.from_numpy(bgate)
    x = rng.standard_normal((2, SEQ, cfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jp["emb"].dtype)
    tx = torch.from_numpy(x).to(pp["emb"].dtype)
    want, (js, jconv) = jax.jit(lambda p, x: JS.mlstm_forward(
        p, cfg, x, jb.rules, return_state=True))(jl, jx)
    got, (ts, tconv) = S.mlstm_forward(tl, cfg, tx, return_state=True)
    assert ts.shape == (2, 4, 32, 33)
    for g, w in ((got, want), (ts, js), (tconv, jconv)):
        assert _rel(_np(g), _np(w)) < TIER[dtype]
    jst, tst = {"ssm": js, "conv": jconv}, {"ssm": ts, "conv": tconv}
    dec = jax.jit(lambda p, x, st: JS.mlstm_decode(p, cfg, x, st, jb.rules))
    for step in range(2):
        x1 = x[:, step:step + 1]
        want1, jst = dec(jl, jnp.asarray(x1).astype(jx.dtype), jst)
        got1, tst = S.mlstm_decode(tl, cfg, torch.from_numpy(x1).to(tx.dtype),
                                   tst)
        assert _rel(_np(got1), _np(want1)) < TIER[dtype]
        assert _rel(_np(tst["ssm"]), _np(jst["ssm"])) < TIER[dtype]
        assert _rel(_np(tst["conv"]), _np(jst["conv"])) < TIER[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_forward_and_decode_match_reference(dtype):
    """One sLSTM block (bias drawn non-zero) stepped over S 100 and its
    carry (c, n, h, m), then two decode steps."""
    jb, jp, pb, pp = _models("pairs", dtype)
    cfg = jb.arch
    rng = np.random.default_rng(4)
    jl = jax.tree.map(lambda a: a[1], jp["slstm"])
    bias = rng.standard_normal(jl["b"].shape, dtype=np.float32)
    jl = {**jl, "b": jnp.asarray(bias)}
    tl = {k: v[1] for k, v in pp["slstm"].items()}
    tl["b"] = torch.from_numpy(bias)
    x = rng.standard_normal((2, SEQ, cfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x).astype(jp["emb"].dtype)
    tx = torch.from_numpy(x).to(pp["emb"].dtype)
    want, jcarry = jax.jit(lambda p, x: JS.slstm_forward(
        p, cfg, x, jb.rules, return_state=True))(jl, jx)
    got, tcarry = S.slstm_forward(tl, cfg, tx, return_state=True)
    assert _rel(_np(got), _np(want)) < TIER[dtype]
    for g, w in zip(tcarry, jcarry):
        assert g.shape == (2, 4, 16)
        assert _rel(_np(g), _np(w)) < TIER[dtype]
    dec = jax.jit(lambda p, x, st: JS.slstm_decode(p, cfg, x, st, jb.rules))
    for step in range(2):
        x1 = x[:, step:step + 1]
        want1, jcarry = dec(jl, jnp.asarray(x1).astype(jx.dtype), jcarry)
        got1, tcarry = S.slstm_decode(tl, cfg,
                                      torch.from_numpy(x1).to(tx.dtype),
                                      tcarry)
        assert _rel(_np(got1), _np(want1)) < TIER[dtype]
        for g, w in zip(tcarry, jcarry):
            assert _rel(_np(g), _np(w)) < TIER[dtype]


@pytest.mark.parametrize("s,chunk", [(SEQ, 16), (37, 64)])
def test_mlstm_scan_route_matches_chunked(s, chunk):
    """The mLSTM's SSD call (heads folded into the lanes, one head a lane,
    N = key depth, P = value depth + 1) through the card's route — on CPU
    tensors the kernel's plain version — against the chunked CPU math."""
    rng = np.random.default_rng(s)
    bh, n, p = 8, 32, 33
    xbar = torch.from_numpy(rng.standard_normal((bh, s, 1, p),
                                                dtype=np.float32))
    la = torch.from_numpy((-rng.random((bh, s, 1)) * 0.5).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((bh, s, n),
                                                   dtype=np.float32) / 6)
              for _ in range(2))
    y, st = S._ssd_kernel_route(xbar, la, bm, cm, chunk)
    y0, st0 = S.ssd_chunked(xbar, la, bm, cm, chunk)
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the models: prefill, decode, caches
# ---------------------------------------------------------------------------
_RUNS = {}


def _prefill_pair(variant, dtype):
    key = (variant, dtype)
    if key not in _RUNS:
        jb, jp, pb, pp = _models(variant, dtype)
        toks = _tokens()
        jl, jcache = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(toks)})
        with torch.inference_mode():
            tl, tcache = pb.prefill_fn(pp, {"tokens": torch.from_numpy(toks)})
        _RUNS[key] = (jl, jcache, tl, tcache)
    return _RUNS[key]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(variant, dtype):
    """Logits and the cache: every mLSTM's (N, P) state and conv window,
    every sLSTM's carry, ``cur``."""
    jl, jcache, tl, tcache = _prefill_pair(variant, dtype)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    assert _rel(_np(tl), _np(jl)) < TIER[dtype]
    if dtype == "f32":
        assert (_np(tl).argmax(-1) == _np(jl).argmax(-1)).all()
    assert set(tcache) == {"m_ssm", "m_conv", "s_state", "cur"}
    _caches_match(tcache, jcache, dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_teacher_forced_matches_reference(variant, dtype):
    """Three decode steps after the prefill, both packages fed the
    reference's greedy tokens (the recurrent state does not grow).  In
    float32 from the port's own prefill cache, the logits and every cache
    leaf held at each step.  In bf16 from the reference's prefill cache,
    carried across, with the logits held at each step and the cache after
    the first: an mLSTM input gate near its cap (exp(4)) multiplies the
    packages' different bf16 roundings of the block's input (XLA rounds a
    fused chain of bf16 products once, PyTorch after each) into the state
    it adds, so the third mLSTM of the "stack" variant drifts to 13% of
    max|state| by the third step while the logits stay within 0.04."""
    jb, jp, pb, pp = _models(variant, dtype)
    jl, jcache, _, tcache = _prefill_pair(variant, dtype)
    assert grow_cache(pb.arch, tcache, 4) is tcache
    if dtype == "bf16":
        tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    else:
        tcache = tree_map(torch.clone, tcache)  # decode writes into its cache
    dec = jax.jit(jb.decode_fn)
    logits = jl
    for step in range(3):
        tok = np.asarray(jnp.argmax(logits, -1)[:, None]).astype(np.int32)
        logits, jcache = dec(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            got, tcache = pb.decode_fn(pp, tcache,
                                       {"tokens": torch.from_numpy(tok)})
        assert _rel(_np(got), _np(logits)) < TIER[dtype]
        if dtype == "f32":
            assert (_np(got).argmax(-1) == _np(logits).argmax(-1)).all()
        if dtype == "f32" or step == 0:
            _caches_match(tcache, jcache, dtype)


def test_decode_from_an_empty_cache_matches_reference():
    """init_cache (zeros, ``cur`` 0) and two decode steps from it."""
    jb, jp, pb, pp = _models("stack", "f32")
    shape = ShapeConfig("d", 8, 2, "decode")
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a,
                          jax_engine.init_cache(jb, shape))
    tcache = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      init_cache(pb, shape, device="cpu"))
    _caches_match(tcache, jcache, "f32")
    dec = jax.jit(jb.decode_fn)
    for step in range(2):
        tok = _tokens(2, 1, seed=10 + step)
        want, jcache = dec(jp, jcache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            got, tcache = pb.decode_fn(pp, tcache,
                                       {"tokens": torch.from_numpy(tok)})
        assert _rel(_np(got), _np(want)) < TIER["f32"]
        _caches_match(tcache, jcache, "f32")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_serve_matches_reference(variant):
    """serve_requests through both engines from the same float32
    parameters (slots refilled from the queue): the same tokens."""
    jb, jp, pb, pp = _models(variant, "f32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (10, 70, 33)]
    want = jax_engine.Engine(jb, jp).serve_requests(
        prompts, batch_size=2, prompt_len=64, n_gen=4)
    got = Engine(pb, pp, device="cpu").serve_requests(
        prompts, batch_size=2, prompt_len=64, n_gen=4)
    for g, w in zip(got, want):
        assert g.shape == (4,)
        assert np.array_equal(g, w)


def test_prefill_decode_consistency_of_the_port():
    """The reference's own check (tests/test_models_smoke.py) on the
    port's blocks, which the reference's reduced config does not have:
    the greedy token of prefill(prompt), decoded once from the cache,
    against prefill(prompt + token), within 0.10 of max|logits| and the
    same argmax."""
    _, _, pb, pp = _models("stack", "f32")
    prompt = torch.from_numpy(_tokens(2, 40, seed=4))
    with torch.inference_mode():
        logits1, cache = pb.prefill_fn(pp, {"tokens": prompt})
        tok = torch.argmax(logits1, -1)[:, None].to(torch.int32)
        logits2, _ = pb.decode_fn(pp, cache, {"tokens": tok})
        logits3, _ = pb.prefill_fn(pp, {"tokens": torch.cat([prompt, tok],
                                                            1)})
    a, b = logits2.numpy(), logits3.numpy()
    assert np.abs(a - b).max() / max(np.abs(b).max(), 1.0) < 0.10
    assert (a.argmax(-1) == b.argmax(-1)).all()


def test_reduced_model_has_no_block_as_in_the_reference():
    """The reference's reduced config (4 layers, slstm_every 8): zero
    groups, a prefill of embedding, final norm and unembedding only, with
    empty stacked caches, and no kernel launch on the CPU."""
    jb = jax_build_model(jax_get_arch("xlstm-350m", reduced=True),
                         remat="none")
    jp = jax_init_tree(jb.decls, jax.random.key(0))
    pb = build_model(get_arch("xlstm-350m", reduced=True))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(2, 12)
    jl, jcache = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(toks)})
    runtime.reset_launch_counts()
    with torch.inference_mode():
        tl, tcache = pb.prefill_fn(pp, {"tokens": torch.from_numpy(toks)})
    assert set(runtime.launch_counts.values()) == {0}
    assert tcache["m_ssm"].shape[0] == 0 and tcache["s_state"].shape[0] == 0
    assert _rel(_np(tl), _np(jl)) < TIER["bf16"]
    _caches_match(tcache, jcache, "bf16")
