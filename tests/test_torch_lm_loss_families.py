"""The port's training loss (``ModelBundle.loss_fn``) against the JAX
package's, on the CPU: the hybrid, xLSTM, encoder-decoder and VLM
families.

Both packages get the same float32 parameters (the reference's
``init_tree`` draw with a JAX key, cast to float32, carried across by
``params_from_numpy`` bit for bit); the VLM's cross-attention gates,
declared zero (tanh(0) would cancel the cross-attention and its
gradients), are drawn non-zero on both sides.  Tokens, targets, frames and
image patches come from numpy with a seed.  The reference's loss and
gradients come from ``jax.value_and_grad(bundle.loss_fn, has_aux=True)``,
the port's from autograd through the plain versions (the CPU route's
chunked SSD math for the hybrid and the mLSTM; the card's route, through
``SsdScanFunction``, is held with its launches emulated in
``tests/test_torch_ssd_backward.py``).

Tiers: the loss within 1e-5 relative; every gradient leaf within 1e-4 of
its largest magnitude.  The models are the reduced configs: zamba2-7b
(S 64, SSD chunk 16), xlstm-350m with ``slstm_every`` 2 (2 groups of one
mLSTM and one sLSTM block: the reduced config's 8 builds no group, ROADMAP
Queue 3), whisper-base (2 + 2 layers, 48 frames against 40 tokens) and
llama-3.2-vision-90b (2 groups, 16 image tokens).
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
from repro_torch.configs import get_arch
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.param import tree_paths

LOSS_TIER = 1e-5
GRAD_TIER = 1e-4
# name -> (arch, config changes, sequence length)
CASES = {
    "hybrid": ("zamba2-7b", {}, 64),
    "xlstm": ("xlstm-350m", {"slstm_every": 2}, 64),
    "encdec": ("whisper-base", {}, 40),
    "vlm": ("llama-3.2-vision-90b", {}, 40),
}
FRAMES = 48
GATES = (0.5, -0.7)


def _cfg(get, name):
    arch, ssm, _ = CASES[name]
    cfg = get(arch, reduced=True)
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    return cfg


def _batch(name):
    cfg = _cfg(get_arch, name)
    s = CASES[name][2]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if name == "encdec":
        out["frames"] = rng.standard_normal((2, FRAMES, cfg.d_frontend),
                                            dtype=np.float32)
    if name == "vlm":
        out["img"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_frontend), dtype=np.float32)
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_reference(name):
    jb = jax_build_model(_cfg(jax_get_arch, name), remat="none",
                         attn_chunk=32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_init_tree(jb.decls, jax.random.key(0)))
    if name == "vlm":
        jp["cross_layers"]["gate"] = jnp.asarray(
            np.asarray(GATES, np.float32)[:, None])
    batch = _batch(name)
    (ref, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    assert set(ref_metrics) == {"ce"}

    pb = build_model(_cfg(get_arch, name), attn_chunk=32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for _, t in tree_paths(params):
        t.requires_grad_(True)
    loss, metrics = pb.loss_fn(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    loss.backward()
    assert set(metrics) == {"ce"} and metrics["ce"] is loss
    loss = loss.detach()
    assert abs(float(loss) - float(ref)) <= LOSS_TIER * abs(float(ref)), \
        (float(loss), float(ref))
    for path, t in tree_paths(params):
        want = np.asarray(_leaf(ref_grads, path))
        got = np.zeros(want.shape, np.float32) if t.grad is None \
            else t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TIER * scale, (name, path, err, scale)
