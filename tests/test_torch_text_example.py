"""The text-confounders twin (``examples/dml_text_confounders_torch.py``)
against the JAX package's example, on the CPU at n_obs 60, M 1, K 2.

Tiers:
  * exact — the data;
  * the initial weights: bf16 leaves bit for bit, float32 leaves within
    2.4e-7 relative (``threefry.normal`` against ``jax.random.normal``);
  * the encoder at the reference's weights within 1e-5 of max|pred|;
  * one step's gradients within 1e-4 of each leaf's max|grad|, except the
    embedding's, held at two bf16 steps of its max (2 * 2^-8): the
    embedding is read in bf16, so its gradient is the bf16 cotangent of
    the first norm's input.  The reference sums that norm's scale's
    cotangent in bf16 (the transpose of a broadcast is a bf16
    ``reduce_sum``), PyTorch sums bf16 in float32, and the two differ by
    a bf16 step in about a fifth of the elements (measured 2.9e-3 of the
    leaf's max; every other leaf within 1.5e-6).  The reference's
    functions are compiled here with XLA's excess precision off, which
    gives what its code says, the values of the same code run op by op
    (within 2.2e-7 of max|pred|, 1.9e-4 and 1.5e-6 of the gradients'
    max): by default XLA drops the bf16 round trip of the embedding, and
    the reference's own compiled training step then differs from its
    op-by-op form by 3.4e-3 of max|pred| and 0.34-1.2% of each gradient
    leaf's max;
  * theta and se after one training step, measured: Adam without bias
    correction turns those bf16 steps into steps of lr, and training
    amplifies them (after 1, 2, 3, 5 steps the two packages' thetas
    measured 0.049, 0.52, 0.84, 1.1 se apart).  Held after one step at
    theta within 0.15 se and se within 4% relative (measured 0.049 se and
    1.2%).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import examples.dml_text_confounders as jtext
from repro.models.param import init_tree as jax_init_tree

import examples.dml_text_confounders_torch as ttext
from repro_torch import threefry
from repro_torch.models.param import params_from_numpy, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
N_OBS = 60
INIT_TOL = 2.4e-7
ENCODE_TOL = 1e-5
GRAD_TOL = 1e-4
EMB_GRAD_TOL = 2 * 2.0 ** -8
THETA_SE_TOL = (0.15, 0.04)


@pytest.fixture(scope="module")
def data():
    return jtext.make_text_data(N_OBS)


@pytest.fixture(scope="module")
def reference_params():
    """The reference's first task's weights (its first split of key 0),
    cast to float32 as its ``lm_learner`` does, as numpy arrays."""
    _, sub = jax.random.split(jax.random.key(0))
    params = jax.jit(lambda key: jax.tree.map(
        lambda p: p.astype(jnp.float32),
        jax_init_tree(jtext.encoder_decls(), key)))(sub)
    return jax.tree.map(np.asarray, params)


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _jax_loss(params, toks, y, w):
    pred = jtext.encode(params, toks)
    return jnp.sum(w * (pred - y) ** 2) / jnp.maximum(jnp.sum(w), 1.0)


def test_twin_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttext.run_small(n_obs=8, n_rep=1, n_folds=2, steps=1)


@pytest.mark.parametrize("n_obs", [N_OBS, 300])
def test_make_text_data_bit_for_bit(n_obs):
    want, got = jtext.make_text_data(n_obs), ttext.make_text_data(n_obs)
    assert want.keys() == got.keys()
    for k in ("tokens", "y", "d"):
        assert want[k].dtype == got[k].dtype
        assert np.array_equal(want[k], got[k]), k
    assert want["theta0"] == got["theta0"]


def test_initial_weights_are_the_references(reference_params):
    _, sub = threefry.split(threefry.key(0))
    got = tree_leaves(ttext.init_params(sub, "cpu"))
    want = jax.tree_util.tree_leaves(reference_params)
    decls = tree_leaves(ttext.encoder_decls())
    assert len(got) == len(want) == len(decls) == 18
    for d, g, w in zip(decls, got, want):
        g = g.numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        if d.dtype == torch.bfloat16:
            assert np.array_equal(g, w), d
        else:
            assert np.abs(g - w).max() <= INIT_TOL * np.abs(w).max(), d


def test_encode_at_the_references_weights(data, reference_params):
    toks = jnp.asarray(data["tokens"])
    want = np.asarray(_compiled(jtext.encode, reference_params, toks)(
        reference_params, toks))
    got = ttext.encode(params_from_numpy(reference_params, "cpu"),
                       torch.from_numpy(data["tokens"])).numpy()
    assert got.shape == (N_OBS,)
    assert np.abs(got - want).max() <= ENCODE_TOL * np.abs(want).max()


def test_one_steps_gradients(data, reference_params):
    w = np.zeros(N_OBS, np.float32)
    w[::2] = 1.0
    args = (reference_params, jnp.asarray(data["tokens"]),
            jnp.asarray(data["y"]), jnp.asarray(w))
    want = jax.tree_util.tree_leaves(
        _compiled(jax.grad(_jax_loss), *args)(*args))
    loss, got = ttext.grads(params_from_numpy(reference_params, "cpu"),
                            torch.from_numpy(data["tokens"]),
                            torch.from_numpy(data["y"]),
                            torch.from_numpy(w))
    assert np.isfinite(float(loss))
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        reference_params)[0]]
    for path, g, want_g in zip(paths, got, want):
        want_g = np.asarray(want_g)
        tol = EMB_GRAD_TOL if path[0].key == "emb" else GRAD_TOL
        gap = np.abs(g.numpy() - want_g).max() / np.abs(want_g).max()
        assert gap <= tol, (path, gap)


def test_theta_and_se_after_one_step():
    want = jtext.run_small(n_obs=N_OBS, n_rep=1, n_folds=2, steps=1)
    got = ttext.run_small(n_obs=N_OBS, n_rep=1, n_folds=2, steps=1,
                          device="cpu")
    assert got.keys() == want.keys() and got["theta0"] == want["theta0"]
    assert np.isfinite(got["theta"]) and got["se"] > 0
    assert abs(got["theta"] - want["theta"]) <= THETA_SE_TOL[0] * want["se"]
    assert abs(got["se"] - want["se"]) <= THETA_SE_TOL[1] * want["se"]
    lo, hi = got["ci"]
    assert lo < got["theta"] < hi


def test_twin_imports_neither_jax_nor_the_jax_package():
    path = ROOT / "examples" / "dml_text_confounders_torch.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots
