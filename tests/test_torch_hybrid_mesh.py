"""The hybrid family (zamba2) served tensor parallel on a mesh — the
Mamba-2 blocks' SSM heads, the shared block's attention heads and MLP
width and the vocabulary over "model", FSDP and the batch over "data"
(``build_model(cfg, MEGATRON_FSDP, mesh)``, parameters placed by
``shard_params``) — against the JAX package's jitted ``build_model`` on
the same mesh, on the CPU, in float32.

The reference runs once, in a subprocess, on four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported) and hands back numpy arrays for every case: its parameters
(drawn from a JAX key, cast to float32; the per-head and per-channel
leaves that are declared constant — ``a_log``, ``dt_bias``, ``d_skip``,
``gnorm``, ``conv_b`` — drawn too, so that a shard taking the wrong heads
shows), the prefill's last logits on 2 x 128 tokens (past the reduced
64-token window), three greedy decode steps with the tokens it fed, the
decode cache after them, and the block of every parameter that its
``sharding_tree`` gives each device.

Cases: the reduced zamba2-7b (2 groups of 2 Mamba-2 blocks and the shared
block; 8 SSM heads of 16, so 2 a shard on a model degree of 4, 4 on 2; 4
attention heads) on (1, 4) and on (2, 2).  Tier: the float32 LM tier, 1e-4
of the reference's largest logit magnitude, the same argmax at every
step; the joined cache within 1e-4 of the reference's largest cached
magnitude.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import runtime
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.models import build_model, init_tree, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.param import (
    cast_floating, shard_params, tree_map, tree_paths,
)
from repro_torch.serving import grow_cache, init_cache
from repro_torch.sharding.axes import MEGATRON_FSDP
from repro_torch.sharding.collectives import ShardedLeaf

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
BATCH, SEQ, STEPS = 2, 128, 3
ARCH = "zamba2-7b"
CASES = {"zamba2_1x4": (1, 4), "zamba2_2x2": (2, 2)}
# the leaves declared constant, drawn on both sides
DRAWN = ("a_log", "dt_bias", "d_skip", "gnorm", "conv_b")

_REFERENCE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.models import build_model, init_tree
from repro.models.param import sharding_tree
from repro.serving.engine import grow_cache
from repro.sharding.axes import MEGATRON_FSDP
assert jax.device_count() == 4
CASES = {cases!r}
DRAWN = {drawn!r}

out = {{}}
for name, dims in CASES.items():
    cfg = get_arch({arch!r}, reduced=True)
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, remat="none",
                         attn_chunk=32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_tree(bundle.decls, jax.random.key(0)))
    for k, leaf in enumerate(DRAWN):
        shape = params["mamba"][leaf].shape
        draw = jax.random.normal(jax.random.key(11 + k), shape, jnp.float32)
        params["mamba"][leaf] = (1.0 + 0.3 * draw if leaf in ("gnorm",
                                                              "d_skip")
                                 else 0.5 * draw)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, ({batch}, {seq})).astype(np.int32)
    logits, cache = jax.jit(bundle.prefill_fn)(params, {{"tokens": tokens}})
    cache = grow_cache(cfg, cache, {steps})
    steps, fed = [np.asarray(logits)], []
    decode = jax.jit(bundle.decode_fn)
    for _ in range({steps}):
        tok = np.asarray(jnp.argmax(steps[-1], -1))[:, None].astype(np.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, {{"tokens": tok}})
        steps.append(np.asarray(logits))
    shardings = sharding_tree(bundle.decls, mesh, MEGATRON_FSDP)
    blocks = jax.tree.map(
        lambda s, a: [tuple((sl.start or 0, a.shape[k] if sl.stop is None
                             else sl.stop) for k, sl in enumerate(idx))
                      for _, idx in sorted(
                          s.devices_indices_map(a.shape).items(),
                          key=lambda item: item[0].id)],
        shardings, params, is_leaf=lambda x: hasattr(x, "spec"))
    out[name] = {{"params": jax.tree.map(np.asarray, params),
                 "tokens": tokens, "logits": steps, "fed": fed,
                 "cache": jax.tree.map(np.asarray, cache), "blocks": blocks}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's hybrid on four forced host devices."""
    path = tmp_path_factory.mktemp("hybrid_mesh") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, drawn=DRAWN, arch=ARCH,
                             batch=BATCH, seq=SEQ, steps=STEPS)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


def _recording(monkeypatch):
    """Record the operand shape of every SSD scan and every prefill
    attention call (the CPU routes of K6 and K5): (B, S, heads, P) and
    (B, S, query heads, D)."""
    seen = {"ssd": [], "attn": []}
    scan, attend = S.ssd_chunked, L._attend

    def ssd(xbar, *args, **kw):
        seen["ssd"].append(tuple(xbar.shape))
        return scan(xbar, *args, **kw)

    def att(q, *args, **kw):
        seen["attn"].append(tuple(q.shape))
        return attend(q, *args, **kw)
    monkeypatch.setattr(S, "ssd_chunked", ssd)
    monkeypatch.setattr(L, "_attend", att)
    return seen


def _run(ref, dims, seen):
    """The port's prefill and decode steps on a simulated mesh, fed the
    reference's tokens: (logits of each step, launch counts and recorded
    calls of each step, the final cache joined, the placed parameters)."""
    cfg = get_arch(ARCH, reduced=True)
    mesh = make_sim_mesh(dims, "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, attn_chunk=32)
    params = shard_params(params_from_numpy(ref["params"], "cpu"),
                          bundle.decls, mesh, MEGATRON_FSDP)
    steps, counts = [], []

    def record():
        counts.append({**runtime.launch_counts,
                       **{k: list(v) for k, v in seen.items()}})
        runtime.reset_launch_counts()
        for v in seen.values():
            v.clear()
    with torch.inference_mode():
        record()
        logits, cache = bundle.prefill_fn(
            params, {"tokens": torch.from_numpy(ref["tokens"])})
        steps.append(logits.numpy())
        record()
        cache = grow_cache(cfg, cache, STEPS)
        for tok in ref["fed"]:
            logits, cache = bundle.decode_fn(
                params, cache, {"tokens": torch.from_numpy(tok)})
            steps.append(logits.numpy())
            record()
    return steps, counts[1:], bundle.join_cache(cache), params


@pytest.fixture(scope="module")
def port(reference):
    with pytest.MonkeyPatch.context() as mp:
        seen = _recording(mp)
        return {name: _run(reference[name], dims, seen)
                for name, dims in CASES.items()}


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", CASES)
def test_hybrid_mesh_matches_reference(reference, port, name, step):
    """Step 0 is the prefill's last logits, steps 1-3 the decode steps'."""
    got, want = port[name][0][step], reference[name]["logits"][step]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TIER, rel
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", CASES)
def test_hybrid_joined_cache_matches_reference(reference, port, name):
    """The decode cache after the three steps joined (``join_cache``:
    every shard's SSM heads, each KV head once, the conv window's x
    channels of every model shard and bm, cm once) is the reference's
    whole cache: states, conv windows, keys and values at the float tier,
    the slot table and positions exactly."""
    got = dict(tree_paths(port[name][2]))
    want = dict(tree_paths(reference[name]["cache"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert np.abs(g - w).max() <= TIER * np.abs(w).max(), path
        else:
            assert np.array_equal(g, w), path


def _want_counts(cfg, dims):
    """The collectives of one prefill or decode step of the hybrid on a
    (dp, tp) mesh, G groups of M Mamba-2 blocks: over "model", the
    lookup's sum, two sums a Mamba-2 block (gnorm's sum of squares and
    out_proj's partials), two a shared-block application (attention and
    MLP), and gathers of each block's in_proj (the flat "ff" placement
    cuts across the z, x, bm, cm, dt pieces) and of the logits; over
    "data" (FSDP), a gather of each block's in_proj and out_proj, of the
    shared block's six projections at each application, and of the
    unembedding."""
    dp, tp = dims
    groups = cfg.n_layers // cfg.shared_attn_every
    mamba = cfg.n_layers - groups
    sums = (1 + 2 * mamba + 2 * groups) if tp > 1 else 0
    gathers = (1 + mamba if tp > 1 else 0) \
        + ((2 * mamba + 6 * groups + 1) if dp > 1 else 0)
    return {"mesh_sum": sums, "mesh_gather": gathers, "mesh_all_to_all": 0}


@pytest.mark.parametrize("name", CASES)
def test_hybrid_mesh_collectives(port, name):
    """Every step runs the collectives counted exactly from the layer
    count; a prefill scans once a Mamba-2 block a shard at a shard's
    (B / dp, S, nh / tp, P) and attends once a group a shard at (B / dp,
    S, H / tp, D); a decode step neither (no kernel: the CPU route)."""
    dims = CASES[name]
    dp, tp = dims
    cfg = get_arch(ARCH, reduced=True)
    s = cfg.ssm
    a = cfg.attention
    groups = cfg.n_layers // cfg.shared_attn_every
    shards = dp * tp
    nh = s.expand * cfg.d_model // s.head_dim
    want = _want_counts(cfg, dims)
    for k, counts in enumerate(port[name][1]):
        assert {key: counts[key] for key in want} == want, (name, k, counts)
        assert counts["flash_attention"] == counts["ssd_scan"] == 0
        if k == 0:
            assert counts["ssd"] == [(BATCH // dp, SEQ, nh // tp,
                                      s.head_dim)] \
                * (shards * (cfg.n_layers - groups))
            assert counts["attn"] == [(BATCH // dp, SEQ, a.n_heads // tp,
                                       a.head_dim)] * (shards * groups)
        else:
            assert counts["ssd"] == counts["attn"] == []


@pytest.mark.parametrize("name", CASES)
def test_hybrid_shard_params_gives_the_reference_blocks(reference, port,
                                                        name):
    """Every placed leaf's part on each shard is the block of the whole
    leaf that the reference's ``sharding_tree`` gives that device
    (in_proj's flat "ff" columns, 74 of 296 a shard); a leaf whose spec
    uses only axes of one shard stays the same tensor."""
    ref = reference[name]
    whole = params_from_numpy(ref["params"], "cpu")
    blocks = dict(tree_paths(ref["blocks"]))
    placed = dict(tree_paths(port[name][3]))
    assert placed[("mamba", "in_proj")].parts[0].shape[-1] == \
        296 // CASES[name][1]
    for path, t in tree_paths(whole):
        leaf = placed[path]
        want = blocks[path]
        if all(b == (0, n) for blk in want for b, n in zip(blk, t.shape)):
            assert isinstance(leaf, torch.Tensor), path
            continue
        assert isinstance(leaf, ShardedLeaf), path
        assert len(leaf.parts) == len(want) == 4
        for part, blk in zip(leaf.parts, want):
            sl = tuple(slice(a, b) for a, b in blk)
            assert torch.equal(part, t[sl]), (path, blk)


def test_hybrid_ssm_heads_that_do_not_split_raise_before_a_launch(
        monkeypatch):
    """4 SSM heads of 32 at a model degree of 8 (the 4 attention heads
    padded to 8 split): the prefill and a decode step raise ``ValueError``
    before they embed a token."""
    base = get_arch(ARCH, reduced=True)
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm,
                                                            head_dim=32))
    bundle = build_model(cfg, MEGATRON_FSDP,
                         mesh=make_sim_mesh((1, 8), "cpu"))
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "_embed_stage", None)
    tokens = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="4 SSM heads"):
        bundle.prefill_fn({}, tokens)
    with pytest.raises(ValueError, match="4 SSM heads"):
        bundle.decode_fn({}, {}, tokens)


@pytest.mark.parametrize("dims", CASES.values())
def test_hybrid_init_cache_on_a_mesh_decodes_as_one_device(dims):
    """``init_cache`` of the hybrid on a mesh is the one-device empty
    cache placed (joined back, the same), and two decode steps from it
    give the one-device steps' logits at the float tier and its state."""
    cfg = get_arch(ARCH, reduced=True)
    mesh = make_sim_mesh(dims, "cpu")
    one = build_model(cfg, MEGATRON_FSDP)
    tp = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
    params = cast_floating(init_tree(
        one.decls, torch.Generator().manual_seed(0), "cpu"), torch.float32)
    shape = ShapeConfig("d", 16, 2, "decode")
    c1 = init_cache(one, shape, device="cpu")
    c2 = init_cache(tp, shape, device="cpu")
    joined = dict(tree_paths(tp.join_cache(c2)))
    for path, t in tree_paths(c1):
        assert torch.equal(joined[path], t), path

    def f32(t):                            # the cache in the params' type
        if isinstance(t, ShardedLeaf):
            return ShardedLeaf([f32(p) for p in t.parts], t.spec, t.mesh)
        return t.float() if t.is_floating_point() else t
    c1, c2 = tree_map(f32, c1), tree_map(f32, c2)
    placed = shard_params(params, tp.decls, mesh, MEGATRON_FSDP)
    with torch.inference_mode():
        for tok in ([[3], [7]], [[5], [1]]):
            tok = {"tokens": torch.tensor(tok, dtype=torch.int32)}
            want, c1 = one.decode_fn(params, c1, tok)
            got, c2 = tp.decode_fn(placed, c2, tok)
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel < TIER, rel
    joined = dict(tree_paths(tp.join_cache(c2)))
    for path, t in tree_paths(c1):
        if t.is_floating_point():
            assert float((joined[path] - t).abs().max()) <= \
                TIER * float(t.abs().max()), path
        else:
            assert torch.equal(joined[path], t), path
