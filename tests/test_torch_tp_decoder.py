"""The decoder family served tensor parallel on a mesh — attention heads,
MLP width and vocabulary over "model", FSDP and the batch over "data"
(``build_model(cfg, MEGATRON_FSDP, mesh)``, parameters placed by
``shard_params``) — against the JAX package's jitted ``build_model`` on
the same mesh, on the CPU, in float32.

The reference runs once, in a subprocess, on four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported) and hands back numpy arrays for every case: its parameters
(drawn from a JAX key, cast to float32), the prefill's last logits on 2 x
128 tokens, three greedy decode steps with the tokens it fed, and the
decode cache after them; and, on a (2, 2) mesh, its ``all_gather(tiled=
True)`` over each axis and the block of every parameter that its
``sharding_tree`` gives each device.  Both sides build under
MEGATRON_FSDP, the rules of the full models (the reduced width would pick
SMALL_DP); a case's config override is applied the same way on both.

Cases: the reduced qwen2.5-32b (QKV biases) on (1, 4) and on (2, 2); the
same with 8 query heads over 2 KV heads on (1, 4), where the placed spec
cuts each KV head in half and the stage gathers ``wk`` / ``wv`` over
"model", and over 4 KV heads on (2, 2), where the KV heads split whole;
the reduced h2o-danube-3-4b on (1, 4), its 128-token prompts past its
64-token window; the reduced deepseek-v2-lite on (2, 1), its MoE layers
whole on every data shard, and on (2, 2), expert parallel beside the
tensor-parallel stages with FSDP over "data".  Tier: the float32 LM tier, 1e-4 of the reference's
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
from repro_torch.models.lm import _embed_stage, join_cache
from repro_torch.models.param import (
    cast_floating, shard_params, tree_map, tree_paths,
)
from repro_torch.serving import grow_cache, init_cache
from repro_torch.sharding.axes import MEGATRON_FSDP
from repro_torch.sharding.collectives import (
    ShardedLeaf, join_spec, mesh_gather, split_spec,
)

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
BATCH, SEQ, STEPS = 2, 128, 3
# name -> (arch, mesh dims, attention override)
CASES = {
    "qwen_1x4": ("qwen2.5-32b", (1, 4), {}),
    "qwen_2x2": ("qwen2.5-32b", (2, 2), {}),
    "qwen_gqa8x2_1x4": ("qwen2.5-32b", (1, 4),
                        {"n_heads": 8, "n_kv_heads": 2}),
    "qwen_gqa8x4_2x2": ("qwen2.5-32b", (2, 2),
                        {"n_heads": 8, "n_kv_heads": 4}),
    "h2o_1x4": ("h2o-danube-3-4b", (1, 4), {}),
    "deepseek_2x1": ("deepseek-v2-lite-16b", (2, 1), {}),
    "deepseek_2x2": ("deepseek-v2-lite-16b", (2, 2), {}),
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
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_arch
from repro.models import build_model, init_tree
from repro.models.param import sharding_tree
from repro.serving.engine import grow_cache
from repro.sharding.axes import MEGATRON_FSDP
from repro.sharding.compat import shard_map_compat
assert jax.device_count() == 4
CASES = {cases!r}


def mesh_of(dims):
    n = dims[0] * dims[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(dims),
                ("data", "model"))


def config(arch, over):
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    return cfg


def bias(params, seed):
    # the QKV biases are declared zero: draw them, so that their split
    # shows
    attn = params["layers"]["attn"]
    for i, k in enumerate(("bq", "bk", "bv")):
        if k in attn:
            attn[k] = jax.random.normal(jax.random.key(seed + i),
                                        attn[k].shape, jnp.float32)
    return params


out = {{}}
for name, (arch, dims, over) in CASES.items():
    cfg = config(arch, over)
    mesh = mesh_of(dims)
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, remat="none",
                         attn_chunk=32)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_tree(bundle.decls, jax.random.key(0)))
    params = bias(params, 7)
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
    blocks = None
    if name in ("qwen_1x4", "qwen_2x2"):
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

# all_gather(tiled=True) over each axis of a (2, 2) mesh, each shard's
# result placed as ("data", "model") blocks
mesh = mesh_of((2, 2))
x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
for axis, dim in (("model", 1), ("data", 0)):
    fn = shard_map_compat(
        lambda b: jax.lax.all_gather(b, axis, axis=dim, tiled=True),
        mesh=mesh, in_specs=(P("data", "model"),),
        out_specs=P("data", "model"))
    out[("gather", axis)] = (x, np.asarray(jax.jit(fn)(x)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _config(arch, over):
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's decoders on four forced host devices."""
    path = tmp_path_factory.mktemp("tp_decoder") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, batch=BATCH, seq=SEQ, steps=STEPS)
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
    mesh, fed the reference's tokens: (logits of each step, launch counts
    of each step, the final cache joined, the placed parameters)."""
    arch, dims, over = CASES[name]
    cfg = _config(arch, over)
    mesh = make_sim_mesh(dims, "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, attn_chunk=32)
    params = shard_params(params_from_numpy(ref["params"], "cpu"),
                          bundle.decls, mesh, MEGATRON_FSDP)
    steps, counts = [], []
    with torch.inference_mode():
        runtime.reset_launch_counts()
        logits, cache = bundle.prefill_fn(
            params, {"tokens": torch.from_numpy(ref["tokens"])})
        steps.append(logits.numpy())
        counts.append(dict(runtime.launch_counts))
        cache = grow_cache(cfg, cache, STEPS)
        for tok in ref["fed"]:
            runtime.reset_launch_counts()
            logits, cache = bundle.decode_fn(
                params, cache, {"tokens": torch.from_numpy(tok)})
            steps.append(logits.numpy())
            counts.append(dict(runtime.launch_counts))
    return steps, counts, join_cache(cfg, cache), params


@pytest.fixture(scope="module")
def port(reference):
    return {name: _run(reference[name], name) for name in CASES}


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("name", CASES)
def test_tp_decoder_matches_reference(reference, port, name, step):
    """Step 0 is the prefill's last logits, steps 1-3 the decode steps'."""
    got, want = port[name][0][step], reference[name]["logits"][step]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TIER, rel
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", CASES)
def test_joined_cache_matches_reference(reference, port, name):
    """The decode cache after the three steps, each shard's batch rows
    and KV heads joined (a KV head held by several model shards once;
    MLA's latent and rope key from the first model shard), is the
    reference's whole cache: keys and values at the float tier, the slot
    table and positions exactly."""
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


def _want_counts(cfg, dims, kv_cut: bool):
    """The collectives of one prefill or decode step of a dense decoder
    of L layers on a (dp, tp) mesh: over "model", the lookup's sum and an
    attention and an MLP sum a layer, and the logits' gather; over "data"
    (FSDP), a gather of each of the layer's placed projections (wq, wk,
    wv, wo and the MLP's two) and of the unembedding; a KV head cut in
    the middle gathers wk, wv and their biases over "model" too."""
    dp, tp = dims
    n = cfg.n_layers
    sums = (1 + 2 * n) if tp > 1 else 0
    gathers = (1 if tp > 1 else 0) + ((6 * n + 1) if dp > 1 else 0)
    if kv_cut:
        gathers += n * (4 if cfg.attention.qkv_bias else 2)
    return {"mesh_sum": sums, "mesh_gather": gathers, "mesh_all_to_all": 0}


def _want_moe_counts(cfg, dims, prefill: bool):
    """The collectives of one prefill or decode step of the reduced
    deepseek-v2-lite (a dense head layer, then MoE layers; MLA) on a
    (dp, tp) mesh.  Over "model", where tp > 1: the lookup's sum, an
    attention sum a layer, the head layer's MLP sum and the logits'
    gather; a MoE layer expert parallel: a prefill exchanges twice, means
    its aux and gathers the shared expert's two leaves over "model" (a2a),
    a decode step sums and means (dense_ep).  Over "data", where dp > 1
    (FSDP): a gather of each placed leaf a layer reads (MLA's wq, wdkv
    and wo; the head layer's MLP's two), of the router and the shared
    expert's two leaves a MoE layer (in a2a each shared leaf once a
    gather over "data" and one over "model"), and of the unembedding; at
    tp 1 the MoE layer runs whole on every data shard: its input
    gathered, and its placed leaves (the router and the shared expert's
    two; the routed experts are not placed on a model axis of one)."""
    dp, tp = dims
    n = cfg.n_layers
    n_dense = cfg.moe.first_dense_layers
    n_moe = n - n_dense
    sums = gathers = all_to_all = 0
    if tp > 1:
        sums += 1 + n + n_dense
        gathers += 1
        if prefill:
            all_to_all += 2 * n_moe
            sums += n_moe
            gathers += 2 * n_moe
        else:
            sums += 2 * n_moe
    if dp > 1:
        gathers += 1 + 3 * n + 2 * n_dense
        gathers += n_moe * (3 if tp > 1 else 4)
    return {"mesh_sum": sums, "mesh_gather": gathers,
            "mesh_all_to_all": all_to_all}


@pytest.mark.parametrize("name", CASES)
def test_tp_decoder_collectives(port, name):
    """Every step runs the collectives counted exactly from the layer
    count, and a flash-attention launch nowhere (the CPU route); the MoE
    decoder's router is placed over "data" (FSDP)."""
    arch, dims, over = CASES[name]
    cfg = _config(arch, over)
    tp = dims[1]
    steps = port[name][1]
    if cfg.family == "moe":
        wants = [_want_moe_counts(cfg, dims, k == 0)
                 for k in range(len(steps))]
        router = port[name][3]["layers"]["moe"]["router"]
        assert isinstance(router, ShardedLeaf) and "data" in router.spec
    else:
        kv_cut = cfg.attention.n_kv_heads % tp != 0
        wants = [_want_counts(cfg, dims, kv_cut)] * len(steps)
    for counts, want in zip(steps, wants):
        assert {k: counts[k] for k in want} == want, (name, counts)
        assert counts["flash_attention"] == 0


@pytest.mark.parametrize("name", ("qwen_1x4", "qwen_2x2"))
def test_shard_params_gives_the_reference_blocks(reference, port, name):
    """Every placed leaf's part on each shard is the block of the whole
    leaf that the reference's ``sharding_tree`` gives that device; a leaf
    whose spec uses only axes of one shard stays the same tensor."""
    ref = reference[name]
    whole = params_from_numpy(ref["params"], "cpu")
    blocks = dict(tree_paths(ref["blocks"]))
    placed = dict(tree_paths(port[name][3]))
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


def test_placed_leaves_on_a_simulated_mesh_are_views(port):
    """On a simulated mesh a placed leaf's parts are views of the leaf
    (no second copy of the weights)."""
    wq = port["qwen_2x2"][3]["layers"]["attn"]["wq"]
    assert wq.spec == (None, "data", "model")
    base = wq.parts[0].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in wq.parts)
    assert port["qwen_2x2"][3]["lnf"].shape == (64,)
    assert isinstance(port["qwen_2x2"][3]["lnf"], torch.Tensor)


def test_moe_on_a_data_axis_drops_as_one_device():
    """On a model axis of one, a MoE layer's dispatch pool is the whole
    batch, as on one device (and in the reference's program): at 4 x 128
    tokens (above the dropless 256) the capacity drops rows, and the
    (2, 1) mesh's prefill logits are one device's at the float tier."""
    cfg = get_arch("deepseek-v2-lite-16b", reduced=True)
    mesh = make_sim_mesh((2, 1), "cpu")
    one = build_model(cfg, MEGATRON_FSDP, attn_chunk=32)
    dp = build_model(cfg, MEGATRON_FSDP, mesh=mesh, attn_chunk=32)
    params = cast_floating(init_tree(
        one.decls, torch.Generator().manual_seed(1), "cpu"), torch.float32)
    placed = shard_params(params, dp.decls, mesh, MEGATRON_FSDP)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(4))
    from repro_torch.models import moe
    real, drops = moe._capacity_dispatch, []

    def record(*args):
        out = real(*args)
        drops.append(int((~out[-1]).sum()))
        return out
    moe._capacity_dispatch = record
    try:
        with torch.inference_mode():
            want, _ = one.prefill_fn(params, {"tokens": tokens})
            got, _ = dp.prefill_fn(placed, {"tokens": tokens})
    finally:
        moe._capacity_dispatch = real
    assert sum(drops) > 0
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < TIER, rel
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dims", ((1, 4), (2, 2)))
def test_vocab_parallel_lookup_is_the_one_device_lookup(dims):
    """Each shard looks up its vocab block, zeros elsewhere, summed over
    "model": bit for bit the one-device lookup, in bf16; one sum."""
    mesh = make_sim_mesh(dims, "cpu")
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn((256, 64), generator=gen).to(torch.bfloat16)
    tokens = torch.randint(0, 256, (4, 37), generator=gen, dtype=torch.int32)
    placed = ShardedLeaf(split_spec(emb, ("model", None), mesh),
                         ("model", None), mesh)
    toks = split_spec(tokens, ("data", None), mesh)
    runtime.reset_launch_counts()
    got = _embed_stage(placed, toks, mesh)
    assert runtime.launch_counts["mesh_sum"] == 1
    assert runtime.launch_counts["mesh_gather"] == 0
    want = torch.nn.functional.embedding(tokens.long(), emb)
    assert torch.equal(join_spec(got, ("data", None, None), mesh), want)


@pytest.mark.parametrize("axis", ("model", "data"))
def test_mesh_gather_over_an_axis_matches_all_gather(reference, axis):
    """``mesh_gather(axis=)`` on a (2, 2) mesh is the reference's
    ``all_gather(tiled=True)`` over that axis, exactly, counted once."""
    x, want = reference[("gather", axis)]
    mesh = make_sim_mesh((2, 2), "cpu")
    spec = ("data", "model")
    parts = split_spec(torch.from_numpy(x), spec, mesh)
    runtime.reset_launch_counts()
    got = mesh_gather(parts, 1 if axis == "model" else 0, mesh, axis=axis)
    assert runtime.launch_counts["mesh_gather"] == 1
    assert np.array_equal(join_spec(got, spec, mesh).numpy(), want)


@pytest.mark.parametrize("arch", ("zamba2-7b", "xlstm-350m", "whisper-base",
                                  "llama-3.2-vision-90b"))
def test_other_families_refuse_a_mesh(arch):
    """The xLSTM and encoder-decoder families under rules that put heads
    over "model" (MEGATRON_FSDP) are not sharded: on a mesh with an axis
    above 1 they declare the reference's trees, and their loss, prefill
    and decode raise there, naming the family and the rules.  The hybrid
    and the VLM serve tensor parallel under those rules: their prefill
    runs on (1, 2), and only their training raises.  On the 1 x 1 mesh
    every family runs as before."""
    cfg = get_arch(arch, reduced=True)
    mesh = make_sim_mesh((1, 2), "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
    if cfg.family in ("hybrid", "vlm"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
            bundle.loss_fn({}, {})
        params = cast_floating(init_tree(
            bundle.decls, torch.Generator().manual_seed(0), "cpu"),
            torch.float32)
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["img"] = torch.zeros((2, cfg.n_frontend_tokens,
                                        cfg.d_frontend))
        with torch.inference_mode():
            logits, _ = bundle.prefill_fn(
                shard_params(params, bundle.decls, mesh, MEGATRON_FSDP),
                batch)
        assert logits.shape == (2, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
    else:
        for fn in (bundle.loss_fn, bundle.prefill_fn, bundle.decode_fn):
            with pytest.raises(NotImplementedError,
                               match="Queue 1 item 1") as err:
                fn({}, {})
            assert f"({cfg.family}) under MEGATRON_FSDP" in str(err.value)
    one = build_model(cfg, MEGATRON_FSDP, mesh=make_sim_mesh((1, 1), "cpu"))
    assert one.prefill_fn is not None and one.mesh is not None


def test_a_split_the_heads_cannot_take_raises_before_a_launch(
        monkeypatch):
    """12 query heads over 4 KV heads at a model degree of 6: a shard's
    two query heads straddle a KV group of 3; the prefill raises before
    it embeds a token."""
    cfg = _config("qwen2.5-32b", {"n_heads": 12, "n_kv_heads": 4})
    bundle = build_model(cfg, MEGATRON_FSDP,
                         mesh=make_sim_mesh((1, 6), "cpu"))
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "_embed_stage", None)
    with pytest.raises(ValueError, match="straddle"):
        bundle.prefill_fn({}, {"tokens": torch.zeros((2, 8),
                                                     dtype=torch.int32)})


def test_init_cache_on_a_mesh_decodes_as_one_device():
    """``init_cache`` of a bundle on a (2, 2) mesh is the one-device empty
    cache placed (joined back, the same), and a decode step from it gives
    the one-device step's logits at the float tier."""
    cfg = _config("qwen2.5-32b", {"n_heads": 8, "n_kv_heads": 2})
    mesh = make_sim_mesh((2, 2), "cpu")
    one = build_model(cfg, MEGATRON_FSDP)
    tp = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
    params = cast_floating(init_tree(
        one.decls, torch.Generator().manual_seed(0), "cpu"), torch.float32)
    shape = ShapeConfig("d", 16, 2, "decode")
    c1 = init_cache(one, shape, device="cpu")
    c2 = init_cache(tp, shape, device="cpu")
    joined = dict(tree_paths(join_cache(cfg, c2)))
    for path, t in tree_paths(c1):
        assert torch.equal(joined[path], t), path

    def f32(t):                            # the cache in the params' type
        if isinstance(t, ShardedLeaf):
            return ShardedLeaf([f32(p) for p in t.parts], t.spec, t.mesh)
        return t.float() if t.is_floating_point() else t
    c1, c2 = tree_map(f32, c1), tree_map(f32, c2)
    tok = {"tokens": torch.tensor([[3], [7]], dtype=torch.int32)}
    with torch.inference_mode():
        want, _ = one.decode_fn(params, c1, tok)
        got, _ = tp.decode_fn(shard_params(params, tp.decls, mesh,
                                           MEGATRON_FSDP), c2, tok)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel < TIER, rel
