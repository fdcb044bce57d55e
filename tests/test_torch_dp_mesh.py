"""The families that serve data parallel on a mesh under SMALL_DP (the
rules of xlstm-350m and whisper-base: the batch over every mesh axis, no
heads over "model"; ``build_model(cfg, SMALL_DP, mesh)``, parameters
placed by ``shard_params``) against the JAX package's jitted
``build_model`` on the same mesh, on the CPU, in float32.

The reference runs once, in a subprocess, on four forced host devices and
hands back numpy arrays for every case: its parameters (drawn from a JAX
key, cast to float32; the VLM's cross-attention gates, declared zero,
drawn non-zero), the prefill's last logits, three greedy decode steps with
the tokens it fed, the decode cache after them, and the spec that its
``sharding_tree`` gives every parameter on that mesh.

Cases: the reduced xlstm-350m with ``slstm_every`` 2 (2 groups of an mLSTM
and an sLSTM block) on (1, 4) and (2, 2), 4 x 128 tokens (one row a
shard); the reduced whisper-base (2 encoder and 2 decoder layers) over 4 x
48 frames and a 128-token prompt on (1, 4) and (2, 2); the reduced VLM (2
groups of a self- and a gated cross-attention layer) on (2, 2) at 2 rows
against 16 image tokens, which the batch over ("data", "model") does not
divide: the rows split over "data" alone and both model shards of a data
place hold them.  Tier: the float32 LM tier, 1e-4 of the reference's
largest logit magnitude, the same argmax at every step; the joined cache
within 1e-4 of the reference's largest cached magnitude.
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
from repro_torch.sharding.axes import SMALL_DP
from repro_torch.sharding.collectives import ShardedLeaf

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
SEQ, FRAMES, STEPS = 128, 48, 3
GATES = (0.5, -0.7)
# name -> (arch, mesh dims, batch rows, ssm override)
CASES = {
    "xlstm_1x4": ("xlstm-350m", (1, 4), 4, {"slstm_every": 2}),
    "xlstm_2x2": ("xlstm-350m", (2, 2), 4, {"slstm_every": 2}),
    "whisper_1x4": ("whisper-base", (1, 4), 4, None),
    "whisper_2x2": ("whisper-base", (2, 2), 4, None),
    "vlm_2x2": ("llama-3.2-vision-90b", (2, 2), 2, None),
}

_REFERENCE = r"""
import dataclasses, os, sys, pickle
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
from repro.sharding.axes import SMALL_DP
assert jax.device_count() == 4
CASES = {cases!r}

out = {{}}
for name, (arch, dims, batch, over) in CASES.items():
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **over))
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    bundle = build_model(cfg, SMALL_DP, mesh=mesh, remat="none",
                         attn_chunk=32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_tree(bundle.decls, jax.random.key(0)))
    rng = np.random.default_rng(5)
    inputs = {{"tokens": rng.integers(0, cfg.vocab_size, (batch, {seq}))
              .astype(np.int32)}}
    if cfg.family == "audio":
        inputs["frames"] = rng.standard_normal(
            (batch, {frames}, cfg.d_frontend)).astype(np.float32)
    if cfg.family == "vlm":
        params["cross_layers"]["gate"] = jnp.asarray(
            np.asarray({gates!r}, np.float32)[:, None])
        inputs["img"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    logits, cache = jax.jit(bundle.prefill_fn)(params, inputs)
    cache = grow_cache(cfg, cache, {steps})
    steps, fed = [np.asarray(logits)], []
    decode = jax.jit(bundle.decode_fn)
    for _ in range({steps}):
        tok = np.asarray(jnp.argmax(steps[-1], -1))[:, None].astype(np.int32)
        fed.append(tok)
        logits, cache = decode(params, cache, {{"tokens": tok}})
        steps.append(np.asarray(logits))
    specs = jax.tree.map(
        lambda s: tuple(e if e is None or isinstance(e, str) else tuple(e)
                        for e in s.spec),
        sharding_tree(bundle.decls, mesh, SMALL_DP),
        is_leaf=lambda x: hasattr(x, "spec"))
    out[name] = {{"params": jax.tree.map(np.asarray, params),
                 "inputs": inputs, "logits": steps, "fed": fed,
                 "cache": jax.tree.map(np.asarray, cache), "specs": specs}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _config(arch, over):
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **over))
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's families on four forced host devices."""
    path = tmp_path_factory.mktemp("dp_mesh") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, seq=SEQ, frames=FRAMES,
                             steps=STEPS, gates=GATES)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


def _run(name, ref, seen):
    """The port's prefill and decode steps of case ``name`` on a simulated
    mesh, fed the reference's tokens: (logits of each step, launch counts
    and recorded scan and attention calls of each step, the final cache
    joined, the final cache as placed)."""
    arch, dims, _, over = CASES[name]
    cfg = _config(arch, over)
    mesh = make_sim_mesh(dims, "cpu")
    bundle = build_model(cfg, SMALL_DP, mesh=mesh, attn_chunk=32)
    params = shard_params(params_from_numpy(ref["params"], "cpu"),
                          bundle.decls, mesh, SMALL_DP)
    inputs = {k: torch.from_numpy(v) for k, v in ref["inputs"].items()}
    steps, counts = [], []

    def record():
        counts.append({**runtime.launch_counts,
                       **{k: list(v) for k, v in seen.items()}})
        runtime.reset_launch_counts()
        for v in seen.values():
            v.clear()
    with torch.inference_mode():
        record()
        logits, cache = bundle.prefill_fn(params, inputs)
        steps.append(logits.numpy())
        record()
        cache = grow_cache(cfg, cache, STEPS)
        for tok in ref["fed"]:
            logits, cache = bundle.decode_fn(
                params, cache, {"tokens": torch.from_numpy(tok)})
            steps.append(logits.numpy())
            record()
    return steps, counts[1:], bundle.join_cache(cache), cache


@pytest.fixture(scope="module")
def port(reference):
    seen = {"ssd": [], "attn": []}
    scan, attend = S.ssd_chunked, L._attend

    def ssd(xbar, *args, **kw):
        seen["ssd"].append(tuple(xbar.shape))
        return scan(xbar, *args, **kw)

    def att(q, k, *args, **kw):
        seen["attn"].append((tuple(q.shape), k.shape[1]))
        return attend(q, k, *args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "ssd_chunked", ssd)
        mp.setattr(L, "_attend", att)
        return {name: _run(name, reference[name], seen) for name in CASES}


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", CASES)
def test_dp_mesh_matches_reference(reference, port, name, step):
    """Step 0 is the prefill's last logits, steps 1-3 the decode steps'."""
    got, want = port[name][0][step], reference[name]["logits"][step]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TIER, rel
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", CASES)
def test_dp_joined_cache_matches_reference(reference, port, name):
    """The decode cache after the three steps, each shard's batch rows
    joined, is the reference's whole cache: states, keys and values at
    the float tier, the slot table and positions exactly."""
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


# the leaves a decode step does not read (an encoder-decoder's encoder, a
# VLM's image projection)
DECODE_UNUSED = {"audio": ("encoder", "enc_lnf", "frontend_proj"),
                 "vlm": ("img_proj",)}


def _want_gathers(specs, dims, skip=()):
    """One gather a step for each mesh axis of more than one shard that
    the reference's spec of a leaf the step reads splits it over: each
    leaf (a stacked leaf holds every layer) gathered whole once."""
    sizes = dict(zip(("data", "model"), dims))
    total = 0
    for path, spec in tree_paths(specs):
        if path[0] in skip:
            continue
        for entry in spec:
            axes = () if entry is None else (entry,) \
                if isinstance(entry, str) else entry
            total += sum(sizes.get(a, 1) > 1 for a in axes)
    return total


def _want_calls(cfg, rows, kind):
    """The scan and attention calls of one shard's prefill of ``rows``
    rows: an xLSTM scans once an mLSTM block at (rows x heads, S, 1, value
    depth + 1); whisper attends once an encoder layer over the frames and
    twice a decoder layer (self, and cross against the frames); the VLM
    once a layer (cross against the image tokens).  Each as (q shape, key
    length)."""
    a = cfg.attention
    if kind == "ssm":
        per = cfg.ssm.slstm_every
        hd = cfg.ssm.expand * cfg.d_model // a.n_heads
        return [(rows * a.n_heads, SEQ, 1, hd + 1)] \
            * (cfg.n_layers // per * (per - 1)), []
    q = (rows, SEQ, a.n_heads, a.head_dim)
    if kind == "audio":
        enc = ((rows, FRAMES, a.n_heads, a.head_dim), FRAMES)
        return [], [enc] * cfg.n_encoder_layers \
            + [(q, SEQ), (q, FRAMES)] * cfg.n_layers
    per = cfg.cross_attn_every
    return [], ([(q, SEQ)] * (per - 1) + [(q, cfg.n_frontend_tokens)]) \
        * (cfg.n_layers // per)


@pytest.mark.parametrize("name", CASES)
def test_dp_mesh_collectives(reference, port, name):
    """Every step gathers each placed leaf it reads over each axis its
    placement splits (counted from the reference's specs), sums nothing,
    and runs the family's calls once a shard on the shard's rows (a
    prefill: ``_want_calls``; a decode step: none, no kernel on the CPU
    route)."""
    arch, dims, batch, over = CASES[name]
    cfg = _config(arch, over)
    shards = dims[0] * dims[1]
    rows = batch // shards if batch % shards == 0 else batch // dims[0]
    specs = reference[name]["specs"]
    ssd, attn = _want_calls(cfg, rows, cfg.family)
    for k, counts in enumerate(port[name][1]):
        want = {"mesh_sum": 0, "mesh_all_to_all": 0,
                "mesh_gather": _want_gathers(
                    specs, dims, () if k == 0 else
                    DECODE_UNUSED.get(cfg.family, ()))}
        assert {key: counts[key] for key in want} == want, (name, k, counts)
        assert counts["flash_attention"] == counts["ssd_scan"] == 0
        if k == 0:
            assert counts["ssd"] == ssd * shards, (name, counts["ssd"])
            assert counts["attn"] == attn * shards, (name, counts["attn"])
        else:
            assert counts["ssd"] == counts["attn"] == []


@pytest.mark.parametrize("name", CASES)
def test_dp_cache_is_held_by_batch_rows(port, name):
    """Every cache leaf is held one part a shard, split by batch rows over
    the axes that divide them, each part a tensor of its own (a decode
    step updates the recurrent states in place, so two shards holding the
    same rows must not share one)."""
    arch, dims, batch, _ = CASES[name]
    entry = ("data", "model") if batch % (dims[0] * dims[1]) == 0 \
        else "data"
    for path, leaf in tree_paths(port[name][3]):
        assert isinstance(leaf, ShardedLeaf), path
        assert entry in leaf.spec, (path, leaf.spec)
        ptrs = {p.untyped_storage().data_ptr() for p in leaf.parts}
        assert len(ptrs) == len(leaf.parts), path


@pytest.mark.parametrize("arch,dims,batch", (("xlstm-350m", (2, 2), 2),
                                             ("whisper-base", (1, 4), 4)))
def test_dp_init_cache_on_a_mesh_decodes_as_one_device(arch, dims, batch):
    """``init_cache`` on a mesh is the one-device empty cache held by
    batch rows (joined back, the same), and two decode steps from it give
    the one-device steps' logits and state at the float tier.  xlstm's 2
    rows split over "data" alone, so both model shards of a data place
    hold them, each its own copy: the recurrent states are updated in
    place."""
    cfg = _config(arch, {"slstm_every": 2} if arch == "xlstm-350m" else None)
    mesh = make_sim_mesh(dims, "cpu")
    one = build_model(cfg, SMALL_DP)
    dp = build_model(cfg, SMALL_DP, mesh=mesh)
    params = cast_floating(init_tree(
        one.decls, torch.Generator().manual_seed(0), "cpu"), torch.float32)
    shape = ShapeConfig("d", 16, batch, "decode")
    c1 = init_cache(one, shape, device="cpu")
    c2 = init_cache(dp, shape, device="cpu")
    joined = dict(tree_paths(dp.join_cache(c2)))
    for path, t in tree_paths(c1):
        assert torch.equal(joined[path], t), path

    def f32(t):                            # the cache in the params' type
        if isinstance(t, ShardedLeaf):
            return ShardedLeaf([f32(p) for p in t.parts], t.spec, t.mesh)
        return t.float() if t.is_floating_point() else t
    c1, c2 = tree_map(f32, c1), tree_map(f32, c2)
    placed = shard_params(params, dp.decls, mesh, SMALL_DP)
    with torch.inference_mode():
        for tok in ([[3], [7], [1], [2]], [[5], [1], [9], [4]]):
            tok = {"tokens": torch.tensor(tok[:batch], dtype=torch.int32)}
            want, c1 = one.decode_fn(params, c1, tok)
            got, c2 = dp.decode_fn(placed, c2, tok)
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel < TIER, rel
    joined = dict(tree_paths(dp.join_cache(c2)))
    for path, t in tree_paths(c1):
        if t.is_floating_point():
            assert float((joined[path] - t).abs().max()) <= \
                TIER * max(float(t.abs().max()), 1e-30), path
        else:
            assert torch.equal(joined[path], t), path


@pytest.mark.parametrize("arch", ("xlstm-350m", "whisper-base",
                                  "llama-3.2-vision-90b"))
def test_dp_training_on_a_mesh_is_refused(arch):
    """Training on a mesh is not ported: the data-parallel bundle's loss
    raises ``NotImplementedError`` naming the family."""
    cfg = get_arch(arch, reduced=True)
    bundle = build_model(cfg, SMALL_DP, mesh=make_sim_mesh((1, 2), "cpu"))
    with pytest.raises(NotImplementedError, match=cfg.family):
        bundle.loss_fn({}, {})
