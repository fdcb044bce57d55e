"""The VLM served tensor parallel under its own rules (MEGATRON_FSDP:
heads, MLP width and vocabulary over "model", FSDP and the batch over
"data"; ``build_model(cfg, MEGATRON_FSDP, mesh)``, parameters placed by
``shard_params``) against the JAX package's jitted ``build_model`` on the
same mesh, on the CPU, in float32.

The reference runs once, in a subprocess, on four forced host devices and
hands back numpy arrays for every case: its parameters (drawn from a JAX
key, cast to float32; the cross-attention gates, declared zero, set to
0.5 and -0.7), the prefill's last logits on 2 x 64 tokens against 16
image tokens, three greedy decode steps with the tokens it fed, the
decode cache after them, and the block of every parameter that its
``sharding_tree`` gives each device.

Cases: the reduced llama-3.2-vision-90b (2 groups of a self-attention
and a gated cross-attention layer) on (1, 4) and (2, 2); the same with 8
query heads over 2 KV heads on (1, 4), where the placed spec cuts each
KV head in half and the stages (the cross layers' too) gather ``wk`` /
``wv`` over "model".  Tier: the float32 LM tier, 1e-4 of the reference's
largest logit magnitude, the same argmax at every step; the joined cache
(the cross keys and values held by KV heads and batch rows, where the
reference declares them by batch rows) within 1e-4 of the reference's
largest cached magnitude.
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
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.param import placed_blocks, shard_params, tree_paths
from repro_torch.serving import grow_cache
from repro_torch.sharding.axes import MEGATRON_FSDP
from repro_torch.sharding.collectives import ShardedLeaf

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
BATCH, SEQ, STEPS = 2, 64, 3
GATES = (0.5, -0.7)
ARCH = "llama-3.2-vision-90b"
# name -> (mesh dims, attention override)
CASES = {
    "vlm_1x4": ((1, 4), {}),
    "vlm_2x2": ((2, 2), {}),
    "vlm_gqa8x2_1x4": ((1, 4), {"n_heads": 8, "n_kv_heads": 2}),
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
from repro.sharding.axes import MEGATRON_FSDP
assert jax.device_count() == 4
CASES = {cases!r}

out = {{}}
for name, (dims, over) in CASES.items():
    cfg = get_arch({arch!r}, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, remat="none",
                         attn_chunk=32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_tree(bundle.decls, jax.random.key(0)))
    params["cross_layers"]["gate"] = jnp.asarray(
        np.asarray({gates!r}, np.float32)[:, None])
    rng = np.random.default_rng(5)
    inputs = {{"tokens": rng.integers(0, cfg.vocab_size, ({batch}, {seq}))
              .astype(np.int32),
              "img": rng.standard_normal(({batch}, cfg.n_frontend_tokens,
                                          cfg.d_frontend)).astype(np.float32)}}
    logits, cache = jax.jit(bundle.prefill_fn)(params, inputs)
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
                 "inputs": inputs, "logits": steps, "fed": fed,
                 "cache": jax.tree.map(np.asarray, cache), "blocks": blocks}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side is small products and many launches of small ops:
    one intra-op thread keeps it from contending with the other test
    workers' threads (the thread count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(over):
    cfg = get_arch(ARCH, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's VLM on four forced host devices."""
    path = tmp_path_factory.mktemp("vlm_mesh") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, arch=ARCH, batch=BATCH, seq=SEQ,
                             steps=STEPS, gates=GATES)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


def _run(ref, name):
    """The port's prefill and decode steps of case ``name`` on a simulated
    mesh, fed the reference's tokens and image: (logits of each step,
    launch counts of each step, the final cache joined, the placed
    parameters)."""
    dims, over = CASES[name]
    cfg = _config(over)
    mesh = make_sim_mesh(dims, "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, attn_chunk=32)
    params = shard_params(params_from_numpy(ref["params"], "cpu"),
                          bundle.decls, mesh, MEGATRON_FSDP)
    inputs = {k: torch.from_numpy(v) for k, v in ref["inputs"].items()}
    steps, counts = [], []
    with torch.inference_mode():
        runtime.reset_launch_counts()
        logits, cache = bundle.prefill_fn(params, inputs)
        steps.append(logits.numpy())
        counts.append(dict(runtime.launch_counts))
        cache = grow_cache(cfg, cache, STEPS)
        for tok in ref["fed"]:
            runtime.reset_launch_counts()
            logits, cache = bundle.decode_fn(
                params, cache, {"tokens": torch.from_numpy(tok)})
            steps.append(logits.numpy())
            counts.append(dict(runtime.launch_counts))
    return steps, counts, bundle.join_cache(cache), params, cache


@pytest.fixture(scope="module")
def port(reference):
    return {name: _run(reference[name], name) for name in CASES}


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", CASES)
def test_vlm_mesh_matches_reference(reference, port, name, step):
    """Step 0 is the prefill's last logits, steps 1-3 the decode steps'."""
    got, want = port[name][0][step], reference[name]["logits"][step]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TIER, rel
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", CASES)
def test_vlm_joined_cache_matches_reference(reference, port, name):
    """The decode cache after the three steps joined (each KV head once)
    is the reference's whole cache, the cross keys and values included:
    keys and values at the float tier, the slot table and positions
    exactly; each shard holds its batch rows and its KV heads of both."""
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
    dims, _ = CASES[name]
    placed = port[name][4]["cross_kv"]["k"]
    assert isinstance(placed, ShardedLeaf)
    assert placed.spec == (None, "data", None, "model", None)
    cfg = _config(CASES[name][1])
    rows = BATCH // dims[0]
    heads = max(cfg.attention.n_kv_heads // dims[1], 1)
    assert placed.parts[0].shape == (2, rows, cfg.n_frontend_tokens, heads,
                                     cfg.attention.head_dim)


def _want_counts(cfg, dims, kv_cut: bool, prefill: bool):
    """The collectives of one prefill or decode step of the VLM of L
    layers (self and cross alike) on a (dp, tp) mesh: over "model", the
    lookup's sum, an attention and an MLP sum a layer and the logits'
    gather; over "data" (FSDP), a gather of each layer's six projections
    and of the unembedding, and at a prefill of ``img_proj``; a KV head
    cut in the middle gathers wk and wv over "model" at every layer."""
    dp, tp = dims
    n = cfg.n_layers
    sums = (1 + 2 * n) if tp > 1 else 0
    gathers = (1 if tp > 1 else 0) \
        + ((6 * n + 1 + (1 if prefill else 0)) if dp > 1 else 0)
    if kv_cut:
        gathers += 2 * n
    return {"mesh_sum": sums, "mesh_gather": gathers, "mesh_all_to_all": 0}


@pytest.mark.parametrize("name", CASES)
def test_vlm_mesh_collectives(port, name):
    """Every step runs the collectives counted exactly from the layer
    count, and a flash-attention launch nowhere (the CPU route)."""
    dims, over = CASES[name]
    cfg = _config(over)
    kv_cut = cfg.attention.n_kv_heads % dims[1] != 0
    for k, counts in enumerate(port[name][1]):
        want = _want_counts(cfg, dims, kv_cut, k == 0)
        assert {c: counts[c] for c in want} == want, (name, k, counts)
        assert counts["flash_attention"] == 0


@pytest.mark.parametrize("name", ("vlm_1x4", "vlm_2x2"))
def test_vlm_shard_params_gives_the_reference_blocks(reference, port, name):
    """Every placed leaf's part on each shard is the block of the whole
    leaf that the reference's ``sharding_tree`` gives that device
    (``img_proj``, placed over "data" by FSDP, included); a leaf whose
    spec uses only axes of one shard stays the same tensor, one block."""
    ref = reference[name]
    whole = params_from_numpy(ref["params"], "cpu")
    blocks = dict(tree_paths(ref["blocks"]))
    placed = dict(tree_paths(port[name][3]))
    mesh = make_sim_mesh(CASES[name][0], "cpu")
    assert "img_proj" in {p[0] for p in placed}
    for path, t in tree_paths(whole):
        leaf = placed[path]
        want = blocks[path]
        distinct = {tuple(b) for b in want}
        assert len(placed_blocks(leaf, mesh)) == len(distinct), path
        if all(b == (0, n) for blk in want for b, n in zip(blk, t.shape)):
            assert isinstance(leaf, torch.Tensor), path
            continue
        assert isinstance(leaf, ShardedLeaf), path
        assert len(leaf.parts) == len(want) == 4
        for part, blk in zip(leaf.parts, want):
            sl = tuple(slice(a, b) for a, b in blk)
            assert torch.equal(part, t[sl]), (path, blk)
    if CASES[name][0][0] > 1:
        assert "data" in placed[("img_proj",)].spec
