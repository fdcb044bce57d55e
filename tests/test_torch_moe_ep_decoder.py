"""The reduced deepseek-v2-lite decoder on a (1, 4) mesh — its MoE layers
expert parallel over "model" — against the JAX package's jitted
``build_model(cfg, rules, mesh)`` on the same mesh, on the CPU, in
float32.

Its dense layers run tensor parallel over "model" too: attention, the dense
head layer, the shared experts and the vocabulary, beside the routed
experts' expert parallelism.

The reference runs once, in a subprocess, on four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported) and hands back numpy arrays: its parameters (drawn from a JAX
key, cast to float32), the prefill's last logits on 2 x 128 tokens (the
a2a path: 64 tokens a shard), and three greedy decode steps (dense_ep),
with the tokens it fed.  Both build under MEGATRON_FSDP, the rules of the
full model, whose "experts" map to "model" (the reduced width would pick
SMALL_DP, which leaves the experts unplaced).  The port gets the same
parameters, placed on a simulated mesh by ``shard_params`` (every leaf
by its spec: the routed experts one slice a shard, the heads, widths and
vocabulary over "model"), and is fed the reference's tokens.
Tier: the float32 LM tier, 1e-4 of the reference's largest logit
magnitude, and the same argmax at every step.
"""
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
from repro_torch.models.param import shard_params
from repro_torch.serving import grow_cache
from repro_torch.sharding.axes import MEGATRON_FSDP
from repro_torch.sharding.collectives import ShardedLeaf

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
ARCH = "deepseek-v2-lite-16b"
BATCH, SEQ, STEPS = 2, 128, 3

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
from repro.serving.engine import grow_cache
from repro.sharding.axes import MEGATRON_FSDP
assert jax.device_count() == 4
cfg = get_arch({arch!r}, reduced=True)
rules = MEGATRON_FSDP
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
bundle = build_model(cfg, rules, mesh=mesh, remat="none", attn_chunk=32)
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_tree(bundle.decls, jax.random.key(0)))
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
out = {{"params": jax.tree.map(np.asarray, params), "tokens": tokens,
       "logits": steps, "fed": fed}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's decoder on four forced host devices."""
    path = tmp_path_factory.mktemp("moe_ep_decoder") / "reference.pkl"
    code = _REFERENCE.format(arch=ARCH, batch=BATCH, seq=SEQ, steps=STEPS)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(reference):
    """The port's prefill and decode steps on a simulated (1, 4) mesh, fed
    the reference's tokens: (logits of each step, launch counts of each
    step, the placed parameters)."""
    cfg = get_arch(ARCH, reduced=True)
    rules = MEGATRON_FSDP
    mesh = make_sim_mesh((1, 4), "cpu")
    bundle = build_model(cfg, rules, mesh=mesh, attn_chunk=32)
    params = shard_params(params_from_numpy(reference["params"], "cpu"),
                          bundle.decls, mesh, rules)
    steps, counts = [], []
    with torch.inference_mode():
        runtime.reset_launch_counts()
        logits, cache = bundle.prefill_fn(
            params, {"tokens": torch.from_numpy(reference["tokens"])})
        steps.append(logits.numpy())
        counts.append(dict(runtime.launch_counts))
        cache = grow_cache(cfg, cache, STEPS)
        for tok in reference["fed"]:
            runtime.reset_launch_counts()
            logits, cache = bundle.decode_fn(
                params, cache, {"tokens": torch.from_numpy(tok)})
            steps.append(logits.numpy())
            counts.append(dict(runtime.launch_counts))
    return steps, counts, params


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_decoder_on_mesh_matches_reference(reference, port, step):
    """Step 0 is the prefill's last logits (a2a), steps 1-3 the decode
    steps' (dense_ep)."""
    got, want = port[0][step], reference["logits"][step]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TIER, rel
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_decoder_on_mesh_runs_the_expert_parallel_paths(port):
    """Every MoE layer of the prefill exchanges twice (a2a), means its
    aux once and gathers the shared expert's two leaves over "model" to
    run it on each shard's own tokens; every decode step's MoE layer sums
    (dense_ep, the shared expert's blocks inside) and means.  Beside
    them, tensor parallel over "model": the vocab-parallel lookup's sum,
    an attention sum a layer, the dense head layer's MLP sum, and the
    logits' gather, in every step.  The routed experts are placed one
    slice a shard."""
    cfg = get_arch(ARCH, reduced=True)
    n_dense = cfg.moe.first_dense_layers
    n_moe = cfg.n_layers - n_dense
    tp_sums = 1 + cfg.n_layers + n_dense
    prefill, *decodes = port[1]
    assert (prefill["mesh_all_to_all"], prefill["mesh_sum"],
            prefill["mesh_gather"]) == \
        (2 * n_moe, tp_sums + n_moe, 1 + 2 * n_moe)
    for counts in decodes:
        assert (counts["mesh_all_to_all"], counts["mesh_sum"],
                counts["mesh_gather"]) == (0, tp_sums + 2 * n_moe, 1)
    wi = port[2]["layers"]["moe"]["wi"]
    assert isinstance(wi, ShardedLeaf)
    assert wi.spec == (None, "model", None, None, None)
    assert [p.shape[1] for p in wi.parts] == [cfg.moe.n_routed // 4] * 4
