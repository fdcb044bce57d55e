"""The port's training loss (``ModelBundle.loss_fn``, ``chunked_ce_loss``,
``_remat``) against the JAX package's, on the CPU: the decoder families.

Both packages get the same float32 parameters: the reference draws them
(``init_tree`` with a JAX key, cast to float32), a few declared-zero
leaves are drawn non-zero from numpy (QKV biases), and
``params_from_numpy`` carries the tree across bit for bit.  Tokens and
targets come from numpy with a seed.  The reference's loss and gradients
come from ``jax.value_and_grad(bundle.loss_fn, has_aux=True)``, the port's
from autograd through the plain versions (on the CPU every kernel wrapper
takes its plain version).

Tiers: the loss within 1e-5 relative; every gradient leaf within 1e-4 of
its largest magnitude (in the reference).  The models are the reduced
configs: h2o-danube-3-4b with GQA 4/2 and QKV biases at S 100 past its
window of 64 (dense), and deepseek-v2-lite-16b (MLA, one dense head
layer, MoE with its aux loss).
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
from repro.models.lm import chunked_ce_loss as jax_chunked_ce_loss
from repro.sharding.axes import rules_for
from repro_torch.configs import get_arch
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.lm import chunked_ce_loss
from repro_torch.models.param import tree_paths

LOSS_TIER = 1e-5
GRAD_TIER = 1e-4
SEQ = 100
# name -> (arch, changes to its reduced attention config)
CASES = {
    "dense": ("h2o-danube-3-4b", {"n_kv_heads": 2, "qkv_bias": True}),
    "mla_moe": ("deepseek-v2-lite-16b", {}),
}


def _with_biases(tree, rng):
    """The tree with every QKV bias drawn from N(0, 0.1)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32)
                            * 0.1) if k in ("bq", "bk", "bv")
                else _with_biases(v, rng)) for k, v in tree.items()}


_CACHE = {}


def _models(name):
    """(reference bundle, its float32 params, port params), module wide."""
    if name not in _CACHE:
        arch, attn = CASES[name]
        jc = jax_get_arch(arch, reduced=True)
        jc = dataclasses.replace(jc, attention=dataclasses.replace(
            jc.attention, **attn))
        jb = jax_build_model(jc, remat="none", attn_chunk=32)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_init_tree(jb.decls, jax.random.key(0)))
        jp = _with_biases(jp, np.random.default_rng(7))
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[name] = (jb, jp, pp)
    return _CACHE[name]


def _port_bundle(name, remat="full"):
    arch, attn = CASES[name]
    pc = get_arch(arch, reduced=True)
    pc = dataclasses.replace(pc, attention=dataclasses.replace(
        pc.attention, **attn))
    return build_model(pc, remat=remat, attn_chunk=32)


def _batch(vocab, b=2, s=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


_REF = {}


def _reference(name, what="loss"):
    """The reference's (value, metrics, gradients) of ``loss_fn`` (or of
    its aux term alone), module wide."""
    key = (name, what)
    if key not in _REF:
        jb, jp, _ = _models(name)
        batch = {k: jnp.asarray(v)
                 for k, v in _batch(jb.arch.vocab_size).items()}
        if what == "loss":
            fn = jb.loss_fn
        else:
            def fn(params, batch):
                m = jb.loss_fn(params, batch)[1]
                return m["aux"], m
        (val, metrics), grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(jp, batch)
        _REF[key] = (float(val), {k: float(v) for k, v in metrics.items()},
                     jax.tree.map(np.asarray, grads))
    return _REF[key]


def _port(name, remat="full", what="loss"):
    """The port's (value, metrics, {path: gradient}) on fresh leaves."""
    jb, _, pp = _models(name)
    pb = _port_bundle(name, remat)
    params = {k: v for k, v in pp.items()}
    leaves = [t for _, t in tree_paths(params)]
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(jb.arch.vocab_size).items()}
    loss, metrics = pb.loss_fn(params, batch)
    val = loss if what == "loss" else metrics["aux"]
    val.backward()
    # a leaf the value does not reach has no .grad (JAX gives zeros)
    grads = {path: torch.zeros_like(t) if t.grad is None else t.grad.clone()
             for path, t in tree_paths(params)}
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return float(val.detach()), {k: float(v.detach())
                                 for k, v in metrics.items()}, grads


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_grads(got, want):
    assert got, "no gradient"
    for path, g in got.items():
        w = _leaf(want, path)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TIER * scale, (path, err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_reference(name):
    val, metrics, grads = _port(name)
    ref_val, ref_metrics, ref_grads = _reference(name)
    assert abs(val - ref_val) <= LOSS_TIER * abs(ref_val), (val, ref_val)
    assert set(metrics) == set(ref_metrics) == {"ce", "aux"}
    for k in metrics:
        assert abs(metrics[k] - ref_metrics[k]) \
            <= LOSS_TIER * max(abs(ref_metrics[k]), 1e-6), k
    _check_grads(grads, ref_grads)


def test_dense_aux_is_zero():
    _, metrics, _ = _port("dense")
    assert metrics["aux"] == 0.0


def test_moe_aux_term_and_its_gradient_match_reference():
    """The MoE load-balancing term on its own: its value and its gradient
    (through the router's probabilities only)."""
    val, _, grads = _port("mla_moe", what="aux")
    ref_val, _, ref_grads = _reference("mla_moe", what="aux")
    assert val > 0
    assert abs(val - ref_val) <= LOSS_TIER * ref_val, (val, ref_val)
    routers = {p: g for p, g in grads.items() if p[-1] == "router"}
    assert routers and any(float(g.abs().max()) > 0
                           for g in routers.values())
    _check_grads(grads, ref_grads)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_modes_give_the_same_loss_and_gradients(remat):
    """"none" and "dots" against "full" on the port: the same arithmetic,
    recomputed or kept, gives the same bits."""
    val, _, grads = _port("dense", remat=remat)
    val_full, _, grads_full = _port("dense", remat="full")
    assert val == val_full
    for path, g in grads.items():
        assert torch.equal(g, grads_full[path]), path


def test_unknown_remat_mode_raises():
    with pytest.raises(KeyError):
        _port_bundle("dense", remat="most")


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 512), (96, 32)])
def test_chunked_ce_loss_matches_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    h = rng.standard_normal((2, s, 24), dtype=np.float32)
    unemb = rng.standard_normal((24, 50), dtype=np.float32)
    tg = rng.integers(0, 50, (2, s)).astype(np.int32)
    want = float(jax_chunked_ce_loss(jnp.asarray(unemb), jnp.asarray(h),
                                     jnp.asarray(tg),
                                     rules_for("toy", "train", 24),
                                     chunk=chunk))
    got = float(chunked_ce_loss(torch.from_numpy(unemb), torch.from_numpy(h),
                                torch.from_numpy(tg), chunk=chunk))
    assert abs(got - want) <= LOSS_TIER * abs(want), (got, want)


def test_chunked_ce_loss_refuses_a_ragged_chunk_as_the_reference():
    """S not a multiple of the chunk: the reference's reshape fails, and
    so does the port (it does not pad or drop the tail)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 100, 8), dtype=np.float32)
    unemb = rng.standard_normal((8, 10), dtype=np.float32)
    tg = rng.integers(0, 10, (2, 100)).astype(np.int32)
    with pytest.raises(TypeError):
        jax_chunked_ce_loss(jnp.asarray(unemb), jnp.asarray(h),
                            jnp.asarray(tg), rules_for("toy", "train", 8),
                            chunk=64)
    with pytest.raises(ValueError, match="multiple"):
        chunked_ce_loss(torch.from_numpy(unemb), torch.from_numpy(h),
                        torch.from_numpy(tg), chunk=64)
