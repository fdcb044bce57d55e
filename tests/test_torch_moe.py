"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the JAX package's (``repro.models.moe``), on the CPU.

Both sides get the same parameters (the reference draws them,
``params_from_numpy`` carries them across) and the same activations, made
from numpy with a seed.  Tiers:
* exact in float32 — the routing and the dispatch: ``top_e``, the stable
  sort by expert, each row's slot ``pos``, ``keep`` and the capacity,
  also for pools of more than 256 tokens, where a full expert drops
  tokens;
* float32 — the gate weights within 1e-5, outputs and the aux loss within
  1e-4 of the reference's largest magnitude;
* bf16 as declared — outputs within 0.08 of it (the tier of
  tests/test_torch_lm.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.models import init_tree as jax_init_tree
from repro.models import moe as JM
from repro.models.param import is_decl as jax_is_decl
from repro.sharding.axes import rules_for
from repro_torch.configs import get_arch
from repro_torch.models import moe as M
from repro_torch.models import params_from_numpy
from repro_torch.models.param import tree_paths

TIER = {"f32": 1e-4, "bf16": 0.08}
ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


_PARAMS = {}


def _moe_params(arch, dtype, ep=1):
    """(reference config, its MoE params, port config, port params)."""
    key = (arch, dtype, ep)
    if key not in _PARAMS:
        jc = jax_get_arch(arch, reduced=True)
        pc = get_arch(arch, reduced=True)
        jp = jax_init_tree(JM.moe_decls(jc, ep), jax.random.key(3))
        if dtype == "f32":
            jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _PARAMS[key] = (jc, jp, pc, pp)
    return _PARAMS[key]


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return jnp.asarray(x).astype(jt), torch.from_numpy(x).to(tt)


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("ep", [1, 16])
def test_moe_decls_match_reference(arch, reduced, ep):
    """Shapes, types and inits as the reference declares them (router and
    shared gate float32; qwen2-moe's 60 experts padded to 64 for an
    expert axis of 16)."""
    jd = JM.moe_decls(jax_get_arch(arch, reduced=reduced), ep)
    pd = M.moe_decls(get_arch(arch, reduced=reduced), ep)
    flat, _ = jax.tree_util.tree_flatten_with_path(jd, is_leaf=jax_is_decl)
    want = {tuple(k.key for k in path): (tuple(d.shape),
                                         np.dtype(d.dtype).name, d.init)
            for path, d in flat}
    got = {path: (tuple(d.shape), str(d.dtype).replace("torch.", ""),
                  d.init) for path, d in tree_paths(pd)}
    assert got == want
    assert pd["router"].dtype == torch.float32
    if arch == "qwen2-moe-a2.7b" and not reduced:
        assert pd["router"].shape[1] == (64 if ep == 16 else 60)
        assert pd["shared_gate"].dtype == torch.float32


# ---------------------------------------------------------------------------
# routing and dispatch: exact in float32
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,e_pad", [(40, 8), (300, 8), (600, 12)])
def test_route_matches_reference(t, e_pad):
    """top_e exactly, the normalised gate weights and the aux loss in
    float32; padded experts (e_pad > n_routed) are never picked."""
    jc, _, pc, _ = _moe_params("qwen2-moe-a2.7b", "f32")
    rng = np.random.default_rng(t)
    router = rng.standard_normal((jc.d_model, e_pad), dtype=np.float32)
    jx, tx = _x((t, jc.d_model), "f32", seed=t)
    jw, je, jaux = JM._route({"router": jnp.asarray(router)}, jc.moe, jx,
                             e_pad)
    tw, te, taux = M._route({"router": torch.from_numpy(router)}, pc.moe,
                            tx, e_pad)
    assert te.dtype == torch.int64
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.abs(tw.numpy() - np.asarray(jw)).max() <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-4 * abs(float(jaux))
    assert int(te.max()) < pc.moe.n_routed


def test_top_k_breaks_ties_to_the_lower_index():
    """Equal probabilities go to the lower expert index, as
    ``jax.lax.top_k`` gives them."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0, 0.0, 0.0],
                          [0.0, 0.0, 0.0, 0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = M._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert idx.tolist() == [[1, 2, 4], [3, 4, 5]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("t", [1, 4, 256, 257, 700])
@pytest.mark.parametrize("e_pad", [8, 64])
def test_capacity_matches_reference(t, e_pad):
    jc, _, pc, _ = _moe_params("deepseek-v2-lite-16b", "f32")
    assert M._capacity(t, pc.moe, e_pad) == JM._capacity(t, jc.moe, e_pad)
    if t <= 256:
        assert M._capacity(t, pc.moe, e_pad) == t       # dropless


@pytest.mark.parametrize("t", [12, 256, 700])
def test_capacity_dispatch_matches_reference(t):
    """The sorted order (stable, by expert), each row's slot, which rows a
    full expert keeps, and the dispatch buffer itself, exactly; a pool of
    700 tokens routed to few experts drops tokens."""
    jc, _, pc, _ = _moe_params("qwen2-moe-a2.7b", "f32")
    e_pad, k = 8, pc.moe.top_k
    rng = np.random.default_rng(t + 1)
    # skewed routing: experts 0-2 take most rows, so some overflow
    top_e = np.stack([rng.permutation(e_pad)[:k] if i % 3 else
                      np.array([0, 1, 2, 3])[:k] for i in range(t)]) \
        .astype(np.int32)
    top_w = rng.random((t, k)).astype(np.float32)
    jx, tx = _x((t, jc.d_model), "f32", seed=t)
    cap = JM._capacity(t, jc.moe, e_pad)
    jbuf, jse, jpos, jst, jsw, jkeep = JM._capacity_dispatch(
        jx, jnp.asarray(top_w), jnp.asarray(top_e), e_pad, cap)
    buf, order, se, pos, st, sw, keep = M._capacity_dispatch(
        tx, torch.from_numpy(top_w), torch.from_numpy(top_e).long(), e_pad,
        cap)
    for got, want in ((se, jse), (pos, jpos), (st, jst), (keep, jkeep)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    assert np.array_equal(order.numpy(),
                          np.argsort(top_e.reshape(-1), kind="stable"))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (t > 256), dropped


def test_combine_sums_in_a_fixed_order():
    """The combine adds each token's rows back in (token, k) order: equal
    to the reference's scatter-add within float32 rounding, and the same
    bits on every call."""
    jc, _, pc, _ = _moe_params("qwen2-moe-a2.7b", "f32")
    t, e_pad, k = 300, 8, pc.moe.top_k
    rng = np.random.default_rng(9)
    top_e = np.stack([rng.permutation(e_pad)[:k] for _ in range(t)]) \
        .astype(np.int32)
    top_w = rng.random((t, k)).astype(np.float32)
    jx, tx = _x((t, jc.d_model), "f32", seed=9)
    cap = JM._capacity(t, jc.moe, e_pad)
    jd = JM._capacity_dispatch(jx, jnp.asarray(top_w), jnp.asarray(top_e),
                               e_pad, cap)
    want = JM._combine(jd[0] * 2.0, *jd[1:], t, cap)
    buf, order, se, pos, _, sw, keep = M._capacity_dispatch(
        tx, torch.from_numpy(top_w), torch.from_numpy(top_e).long(), e_pad,
        cap)
    got = M._combine(buf * 2.0, order, se, pos, sw, keep, t)
    again = M._combine(buf * 2.0, order, se, pos, sw, keep, t)
    assert torch.equal(got, again)
    assert _rel(_np(got), _np(want)) < 1e-6


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [3, 150])        # dropless; past 256 tokens
def test_moe_forward_matches_reference(arch, dtype, seq):
    """Routed and shared experts (qwen2-moe's sigmoid-gated shared expert,
    deepseek's ungated one) and the aux loss, at a decode-sized pool and a
    prefill pool of 300 tokens (capacity drops)."""
    jc, jp, pc, pp = _moe_params(arch, dtype)
    jx, tx = _x((2, seq, jc.d_model), dtype, seed=seq)
    rules = rules_for(jc.name, "train", jc.d_model)
    want, jaux = jax.jit(lambda p, x: JM.moe_forward(p, jc, x, rules))(jp,
                                                                       jx)
    with torch.inference_mode():
        got, aux = M.moe_forward(pp, pc, tx)
    assert got.dtype == tx.dtype
    assert _rel(_np(got), _np(want)) < TIER[dtype]
    assert abs(float(aux) - float(jaux)) <= TIER[dtype] * abs(float(jaux))
    # the router is float32 whatever the activations' type
    assert pp["router"].dtype == torch.float32


def test_moe_forward_is_deterministic():
    _, _, pc, pp = _moe_params("deepseek-v2-lite-16b", "bf16")
    _, tx = _x((2, 150, pc.d_model), "bf16", seed=4)
    with torch.inference_mode():
        a, _ = M.moe_forward(pp, pc, tx)
        b, _ = M.moe_forward(pp, pc, tx)
    assert torch.equal(a, b)


def test_padded_experts_matches_reference():
    for arch in ARCHS:
        for ep in (1, 2, 16, 64):
            m = get_arch(arch).moe
            assert M.padded_experts(m, ep) == JM.padded_experts(
                jax_get_arch(arch).moe, ep)
    assert M.padded_experts(get_arch("qwen2-moe-a2.7b").moe, 16) == 64
