"""The dense decoders trained on a mesh — ``loss_fn`` of
``build_model(cfg, MEGATRON_FSDP, mesh)`` under autograd (tensor parallel
over "model", FSDP and the batch over "data"), the placed AdamW update,
``Trainer(bundle, opt_cfg, tcfg, mesh)`` and its checkpoints — against
the JAX package's jitted ``value_and_grad`` and ``Trainer(mesh)`` on the
same mesh, on the CPU, in float32.

The reference runs once, in a subprocess, on four forced host devices and
hands back numpy arrays: for each case its parameters (drawn from a JAX
key, cast to float32, the QKV biases drawn non-zero), the batch of 4 x 128
tokens and targets, the loss and every gradient leaf; and a three-step
``Trainer.run`` of the reduced qwen2.5-32b on (2, 2) from float32
parameters, its initial parameters and loss curve.

Cases: the reduced qwen2.5-32b (QKV biases) on (1, 4) and (2, 2); the
same with 8 query heads over 2 KV heads on (1, 4), where the placed spec
cuts each KV head in half (``wk`` / ``wv`` gathered over "model" and their
gradients reduce-scattered back); the reduced h2o-danube-3-4b on (2, 2),
its 128-token rows past its 64-token window.  Tiers: the training tiers,
the loss within 1e-5 relative and every joined gradient leaf within 1e-4
of its max|grad|; the loss curve within 1e-4 relative; the placed update
within rtol 1e-6 / atol 1e-7 of the one-device update.
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
from repro_torch.models import build_model, init_tree, params_from_numpy
from repro_torch.models.param import (
    placed_blocks, shard_params, tree_leaves, tree_map,
    tree_paths,
)
from repro_torch.sharding.axes import MEGATRON_FSDP, SMALL_DP
from repro_torch.sharding.collectives import ShardedLeaf
from repro_torch.train import (
    Checkpointer, OptConfig, Trainer, TrainerConfig, adamw_update,
    init_opt_state, make_train_step,
)
from repro_torch.train.optimizer import (
    global_norm, shard_opt_state,
)
from repro_torch.train.trainer import grads_of, reduce_shares, shares_of

SRC = Path(__file__).resolve().parent.parent / "src"
LOSS_TIER, GRAD_TIER, CURVE_TIER = 1e-5, 1e-4, 1e-4
BATCH, SEQ, CURVE_STEPS = 4, 128, 3
OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
# name -> (arch, mesh dims, attention override)
CASES = {
    "qwen_1x4": ("qwen2.5-32b", (1, 4), {}),
    "qwen_2x2": ("qwen2.5-32b", (2, 2), {}),
    "qwen_gqa8x2_1x4": ("qwen2.5-32b", (1, 4),
                        {"n_heads": 8, "n_kv_heads": 2}),
    "h2o_2x2": ("h2o-danube-3-4b", (2, 2), {}),
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import build_model, init_tree
from repro.models.param import sharding_tree
from repro.sharding.axes import MEGATRON_FSDP
from repro.train.optimizer import OptConfig, init_opt_state
from repro.train.trainer import Trainer, TrainerConfig
assert jax.device_count() == 4
CASES = {cases!r}


def mesh_of(dims):
    return Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))


def config(arch, over):
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    return cfg


def draw(bundle, seed):
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_tree(bundle.decls, jax.random.key(seed)))
    attn = params["layers"]["attn"]
    for i, k in enumerate(("bq", "bk", "bv")):
        if k in attn:
            attn[k] = jax.random.normal(jax.random.key(seed + 7 + i),
                                        attn[k].shape, jnp.float32)
    return params


def batch_of(cfg, seed):
    rng = np.random.default_rng(seed)
    return {{k: rng.integers(0, cfg.vocab_size, ({batch}, {seq}))
            .astype(np.int32) for k in ("tokens", "targets")}}


out = {{}}
for name, (arch, dims, over) in CASES.items():
    cfg = config(arch, over)
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh_of(dims),
                         remat="none", attn_chunk=32)
    params = draw(bundle, 0)
    batch = batch_of(cfg, 5)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        bundle.loss_fn, has_aux=True))(params, batch)
    out[name] = {{"params": jax.tree.map(np.asarray, params),
                 "batch": batch, "loss": float(loss),
                 "grads": jax.tree.map(np.asarray, grads)}}

# the trainer on (2, 2): float32 parameters placed by their specs
cfg = config("qwen2.5-32b", {{}})
mesh = mesh_of((2, 2))
bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, remat="none",
                     attn_chunk=32)
opt_cfg = OptConfig(lr={lr}, warmup_steps={warmup}, total_steps={total})
trainer = Trainer(bundle, opt_cfg, TrainerConfig(steps={steps}, log_every=1),
                  mesh)
params = draw(bundle, 1)
shardings = sharding_tree(bundle.decls, mesh, MEGATRON_FSDP)
opt = init_opt_state(params, opt_cfg)
# float32 parameters: the master must not be the same buffers (run
# donates both)
opt["master"] = jax.tree.map(jnp.copy, opt["master"])
first = jax.tree.map(np.asarray, params)
params = jax.device_put(params, shardings)
opt = jax.device_put(opt, {{"step": NamedSharding(mesh, P()),
                           "master": shardings, "m": shardings,
                           "v": shardings}})
batches = [batch_of(cfg, 10 + i) for i in range({steps})]
_, _, hist = trainer.run(params, opt, iter(batches))
out["trainer"] = {{"params": first, "batches": batches,
                  "losses": [h["loss"] for h in hist]}}
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


def _config(arch, over):
    cfg = get_arch(arch, reduced=True)
    if over:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, **over))
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's value_and_grad and Trainer on four forced host
    devices."""
    path = tmp_path_factory.mktemp("train_mesh") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, batch=BATCH, seq=SEQ,
                             steps=CURVE_STEPS, lr=OPT.lr,
                             warmup=OPT.warmup_steps, total=OPT.total_steps)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


def _mesh_bundle(name, remat="none"):
    arch, dims, over = CASES[name]
    mesh = make_sim_mesh(dims, "cpu")
    return build_model(_config(arch, over), MEGATRON_FSDP, mesh=mesh,
                       remat=remat, attn_chunk=32), mesh


def _batch(ref):
    return {k: torch.from_numpy(v) for k, v in ref["batch"].items()}


def _value_and_grad(ref, name, remat="none"):
    """(loss, the joined gradients by path, launch counts) of the port's
    ``loss_fn`` on case ``name``'s simulated mesh."""
    bundle, mesh = _mesh_bundle(name, remat)
    whole = params_from_numpy(ref["params"], "cpu")
    placed = shard_params(whole, bundle.decls, mesh, MEGATRON_FSDP)
    runtime.reset_launch_counts()
    loss, metrics, shares = shares_of(bundle.loss_fn, placed, _batch(ref),
                                      mesh)
    counts = dict(runtime.launch_counts)
    grads = reduce_shares(shares, placed, mesh)
    joined = {path: g.join() if isinstance(g, ShardedLeaf) else g
              for path, g in tree_paths(grads)}
    return float(loss), joined, counts, metrics


@pytest.fixture(scope="module")
def port(reference):
    return {name: _value_and_grad(reference[name], name) for name in CASES}


@pytest.mark.parametrize("name", CASES)
def test_mesh_loss_matches_reference(reference, port, name):
    got, want = port[name][0], reference[name]["loss"]
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_TIER * abs(want), (got, want)
    assert set(port[name][3]) == {"ce", "aux"}
    assert float(port[name][3]["aux"]) == 0.0


@pytest.mark.parametrize("name", CASES)
def test_mesh_gradients_match_reference(reference, port, name):
    """Every parameter's gradient, each shard's share summed over the
    shards that hold its block and joined, within 1e-4 of the
    reference's max|grad| for that leaf."""
    got = port[name][1]
    want = dict(tree_paths(reference[name]["grads"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= GRAD_TIER * scale, path


def _want_counts(cfg, dims, kv_cut: bool):
    """One value_and_grad of a dense decoder of L layers on a (dp, tp)
    mesh at remat "none", one loss chunk: the forward's collectives as a
    prefill's (over "model" the lookup's sum, an attention and an MLP sum
    a layer; over "data" a gather of each layer's six projections and of
    the unembedding), the loss chunk's logits gathered over "model" twice
    (the chunk is checkpointed), and each backward the adjoint of one
    forward collective: a sum for a sum, a reduce-scatter for a gather."""
    dp, tp = dims
    n = cfg.n_layers
    sums = (1 + 2 * n) if tp > 1 else 0
    fsdp = (6 * n + 1) if dp > 1 else 0
    cut = n * (4 if cfg.attention.qkv_bias else 2) if kv_cut else 0
    return {"mesh_sum": sums, "mesh_sum_bwd": sums,
            "mesh_gather": fsdp + cut + (2 if tp > 1 else 0),
            "mesh_gather_bwd": fsdp + cut + (1 if tp > 1 else 0),
            "mesh_all_to_all": 0}


@pytest.mark.parametrize("name", CASES)
def test_mesh_training_collectives(port, name):
    arch, dims, over = CASES[name]
    cfg = _config(arch, over)
    want = _want_counts(cfg, dims, cfg.attention.n_kv_heads % dims[1] != 0)
    counts = port[name][2]
    assert {k: counts[k] for k in want} == want, counts
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0


def test_remat_modes_give_the_same_bits(reference, port):
    """remat "full" and "dots" recompute the layers' stages (their
    collectives again) and give the loss and gradients of "none" bit for
    bit."""
    name = "h2o_2x2"
    loss0, grads0 = port[name][:2]
    for remat in ("full", "dots"):
        loss, grads, counts, _ = _value_and_grad(reference[name], name,
                                                 remat)
        assert loss == loss0, remat
        for path, g in grads0.items():
            assert torch.equal(grads[path], g), (remat, path)
        assert counts["mesh_sum"] > port[name][2]["mesh_sum"]


def _whole(ref):
    return params_from_numpy(ref["params"], "cpu")


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _joined(tree):
    return {path: (t.join() if isinstance(t, ShardedLeaf) else t)
            for path, t in tree_paths(tree)}


@pytest.mark.parametrize("compress", (False, True))
def test_placed_adamw_matches_one_device(reference, port, compress):
    """Three updates of the placed trees with the joined gradients placed
    are within rtol 1e-6 / atol 1e-7 of the one-device updates: every
    block is written once (a simulated mesh's views would otherwise take
    the step up to four times), the global norm counts each block once,
    int8 compression scales each leaf by its largest magnitude over all
    its blocks."""
    name = "qwen_2x2"
    bundle, mesh = _mesh_bundle(name)
    cfg = dataclasses.replace(OPT, compress_grads=compress, clip_norm=0.5)
    whole = _whole(reference[name])
    grads = tree_map(torch.from_numpy, reference[name]["grads"])
    one_p, one_s = _clone(whole), init_opt_state(whole, cfg)
    mesh_whole = _clone(whole)
    mesh_p = shard_params(mesh_whole, bundle.decls, mesh, MEGATRON_FSDP)
    mesh_s = shard_opt_state(init_opt_state(mesh_whole, cfg), bundle.decls,
                             mesh, MEGATRON_FSDP)
    mesh_g = shard_params(grads, bundle.decls, mesh, MEGATRON_FSDP)
    for k in range(3):
        one_p, one_s, m1 = adamw_update(one_p, grads, one_s, cfg)
        mesh_p, mesh_s, m2 = adamw_update(mesh_p, mesh_g, mesh_s, cfg,
                                          mesh)
        assert float(m2["grad_norm"]) == pytest.approx(
            float(m1["grad_norm"]), rel=1e-6)
    assert int(mesh_s["step"]) == 3
    for tree, want in ((mesh_p, one_p), (mesh_s["master"], one_s["master"]),
                       (mesh_s["m"], one_s["m"]), (mesh_s["v"], one_s["v"]))\
            + (((mesh_s["err"], one_s["err"]),) if compress else ()):
        got = _joined(tree)
        for path, w in tree_paths(want):
            torch.testing.assert_close(got[path], w, rtol=1e-6, atol=1e-7)


def test_global_norm_counts_each_block_once(reference):
    """``global_norm`` of the gradients placed on (2, 2) (a leaf
    replicated over "data" held twice, one over both axes four times)
    is the one-device norm of the joined tree."""
    name = "qwen_2x2"
    bundle, mesh = _mesh_bundle(name)
    grads = tree_map(torch.from_numpy, reference[name]["grads"])
    placed = shard_params(grads, bundle.decls, mesh, MEGATRON_FSDP)
    runtime.reset_launch_counts()
    got = global_norm(placed, mesh)
    assert runtime.launch_counts["mesh_sum"] == 2       # over each axis
    assert float(got) == pytest.approx(float(global_norm(grads)), rel=1e-6)


def test_microbatches_split_each_data_shard(reference):
    """Two microbatches on (2, 2), each of one row of each data shard's
    two, give the full batch's step: its loss, gradient norm and new
    master weights."""
    name = "qwen_2x2"
    bundle, mesh = _mesh_bundle(name)
    out = []
    for n_micro in (1, 2):
        whole = _whole(reference[name])
        params = shard_params(whole, bundle.decls, mesh, MEGATRON_FSDP)
        state = shard_opt_state(init_opt_state(whole, OPT), bundle.decls,
                                mesh, MEGATRON_FSDP)
        step = make_train_step(bundle, OPT, n_micro, mesh)
        _, state, metrics = step(params, state, _batch(reference[name]))
        out.append((metrics, _joined(state["master"])))
    (m1, w1), (m2, w2) = out
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    for path, w in w1.items():
        torch.testing.assert_close(w2[path], w, rtol=1e-5, atol=1e-6)


def test_trainer_on_a_mesh_follows_the_reference_curve(reference):
    """Three ``Trainer(bundle, opt_cfg, tcfg, mesh).run`` steps on (2, 2)
    from the reference's float32 parameters and batches: each step's loss
    within 1e-4 relative of the reference's ``Trainer(mesh)``."""
    ref = reference["trainer"]
    bundle, mesh = _mesh_bundle("qwen_2x2")
    trainer = Trainer(bundle, OPT, TrainerConfig(steps=CURVE_STEPS,
                                                 log_every=1), mesh)
    whole = params_from_numpy(ref["params"], "cpu")
    params, state = trainer.place(whole, init_opt_state(whole, OPT))
    assert isinstance(params["layers"]["attn"]["wq"], ShardedLeaf)
    batches = iter(ref["batches"])
    _, _, hist = trainer.run(params, state, batches)
    got = [h["loss"] for h in hist]
    assert len(got) == len(ref["losses"]) == CURVE_STEPS
    for g, w in zip(got, ref["losses"]):
        assert abs(g - w) <= CURVE_TIER * abs(w), (got, ref["losses"])


def test_checkpoint_on_a_mesh_is_the_one_device_payload(tmp_path):
    """A checkpoint written from trees placed on (2, 2) holds the joined
    leaves: its file is byte for byte the one written from the same
    trees on one device."""
    cfg = _config("qwen2.5-32b", {})
    mesh = make_sim_mesh((2, 2), "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
    params = init_tree(bundle.decls, torch.Generator().manual_seed(2), "cpu")
    state = init_opt_state(params, OPT)
    state["m"] = tree_map(lambda t: torch.randn_like(t), state["m"])
    one, placed = Checkpointer(str(tmp_path / "one"), async_write=False), \
        Checkpointer(str(tmp_path / "mesh"), async_write=False)
    one.save(3, params, state, extra={"data_step": 3})
    placed.save(3, shard_params(params, bundle.decls, mesh, MEGATRON_FSDP),
                shard_opt_state(state, bundle.decls, mesh, MEGATRON_FSDP),
                extra={"data_step": 3})
    name = "ckpt_00000003.msgpack"
    assert (tmp_path / "one" / name).read_bytes() \
        == (tmp_path / "mesh" / name).read_bytes()


def test_trainer_resumes_on_a_mesh_bit_for_bit(tmp_path):
    """``Trainer(mesh)`` with bf16 parameters drawn and placed by
    ``init``: a step and a checkpoint, then a second trainer resumes on
    the mesh (``resume`` places what it restores) and takes steps 2-3;
    its losses and final parameters are bit for bit those of three steps
    in one run."""
    cfg = _config("qwen2.5-32b", {})
    mesh = make_sim_mesh((2, 2), "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, attn_chunk=32)
    rng = np.random.default_rng(3)
    batches = [{k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
                for k in ("tokens", "targets")} for _ in range(3)]

    def trainer(steps, ckpt=None):
        return Trainer(bundle, OPT, TrainerConfig(
            steps=steps, log_every=1, ckpt_every=1 if ckpt else 0,
            ckpt_dir=ckpt), mesh)
    whole = trainer(3)
    p, s = whole.init(0, "cpu")
    p, s, hist = whole.run(p, s, iter(batches))
    first = trainer(1, str(tmp_path))
    q, t = first.init(0, "cpu")
    first.run(q, t, iter(batches))
    second = trainer(3, str(tmp_path))
    q, t, start = second.resume("cpu")
    assert start == 1
    assert isinstance(q["layers"]["mlp"]["wi"], ShardedLeaf)
    q, t, rest = second.run(q, t, iter(batches[start:]), start_step=start)
    assert [h["loss"] for h in rest] == [h["loss"] for h in hist[1:]]
    got, want = _joined(q), _joined(p)
    for path, w in want.items():
        assert torch.equal(got[path], w), path
    assert torch.equal(_joined(t["master"])[("lnf",)],
                       _joined(s["master"])[("lnf",)])


def test_trainer_init_places_every_block_once():
    """``Trainer(mesh).init`` places the parameters and master, m and v by
    their specs; a leaf the rules put on no axis above one is one tensor
    every shard shares, a leaf over "model" alone is one block a model
    place, replicated over "data"."""
    cfg = _config("qwen2.5-32b", {})
    mesh = make_sim_mesh((2, 2), "cpu")
    bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
    trainer = Trainer(bundle, OPT, TrainerConfig(), mesh)
    params, state = trainer.init(0, "cpu")
    for tree in (params, state["master"], state["m"], state["v"]):
        assert isinstance(tree["lnf"], torch.Tensor)
        emb = tree["emb"]
        assert isinstance(emb, ShardedLeaf) and emb.spec == ("model", None)
        blocks = placed_blocks(emb, mesh)
        assert [b.shards for b in blocks] == [(0, 2), (1, 3)]
        assert all(b.replicas == ("data",) for b in blocks)
    assert placed_blocks(params["lnf"], mesh)[0].replicas == ("data",
                                                               "model")
    with pytest.raises(ValueError, match="lead device"):
        trainer.init(0, "meta")


@pytest.mark.parametrize("arch,rules", (
    ("deepseek-v2-lite-16b", MEGATRON_FSDP), ("zamba2-7b", MEGATRON_FSDP),
    ("llama-3.2-vision-90b", MEGATRON_FSDP), ("xlstm-350m", SMALL_DP)))
def test_other_families_refuse_training_on_a_mesh(arch, rules):
    """The MoE decoder (expert parallel), the hybrid, the VLM and every
    family of the data-parallel form keep refusing ``loss_fn`` on a mesh,
    naming ROADMAP Queue 1 item 1 (their training is not ported)."""
    cfg = get_arch(arch, reduced=True)
    bundle = build_model(cfg, rules, mesh=make_sim_mesh((2, 2), "cpu"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        bundle.loss_fn({}, {})


def test_one_device_grads_of_is_unchanged(reference):
    """``grads_of`` without a mesh is the one-device route: its loss is
    the mesh's at the training tier."""
    name = "qwen_1x4"
    cfg = _config(*CASES[name][::2])
    one = build_model(cfg, MEGATRON_FSDP, remat="none", attn_chunk=32)
    loss, _, grads = grads_of(one.loss_fn, _whole(reference[name]),
                              _batch(reference[name]))
    assert abs(float(loss) - reference[name]["loss"]) \
        <= LOSS_TIER * reference[name]["loss"]
    assert all(isinstance(g, torch.Tensor) for g in tree_leaves(grads))
