"""DML with TEXT confounders on the PyTorch/CUDA port —
``examples/dml_text_confounders.py`` one for one, with ``repro_torch`` in
place of ``repro``: the nuisance functions g0/m0 are estimated by a small
transformer encoder over token sequences, trained inside cross-fitting.

DGP: each unit i has a token sequence X_i (its "document"); both treatment
propensity and outcome depend on latent sequence features (pattern counts).
Per cross-fitting task, an encoder (embedding -> attention/MLP blocks ->
mean-pool -> linear head) is trained on the fold's training rows only, and
returns held-out predictions — the same prediction-only discipline as every
other learner in the grid.

Each task's initial weights are the reference's: its key is drawn from
JAX's stream (``repro_torch.threefry``), split once a leaf in the
declaration tree's sorted order, each leaf ``normal / sqrt(fan_in)``
rounded to its declared type, then cast to float32.  The encoder runs in
float32 from its first norm on (a bf16 activation times a float32 weight
is float32), so on the card every attention call is the split-TF32 flash
attention kernel (K5's float32 forward) and its gradient K5's float32
backward: per task 150 steps of two forwards and two backwards, and two
forwards for the held-out prediction.

Run:  python examples/dml_text_confounders_torch.py [--device cuda|cpu]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import threefry
from repro_torch.configs.base import AttentionConfig
from repro_torch.core.aggregation import aggregate_thetas, confint
from repro_torch.core.crossfit import draw_fold_masks, stitch_predictions
from repro_torch.core.scores import plr_score, score_se, solve_theta
from repro_torch.models.layers import (
    attn_decls, attn_forward, mlp_forward, rms_norm,
)
from repro_torch.models.param import PDecl, tree_leaves, tree_unflatten
from repro_torch.runtime import resolve_device

F32 = torch.float32
VOCAB, SEQ, D = 64, 24, 32
ATTN = AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=8, causal=False)


def make_text_data(n_obs=300, theta=0.5, seed=0):
    """Sequences whose pattern statistics confound treatment and outcome."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (n_obs, SEQ)).astype(np.int32)
    # latent features: frequency of "low" tokens and of repeated bigrams
    f1 = (toks < VOCAB // 4).mean(axis=1)
    f2 = (toks[:, 1:] == toks[:, :-1]).mean(axis=1)
    conf = 2.0 * f1 + 4.0 * f2
    d = conf + 0.5 * rng.standard_normal(n_obs)
    y = theta * d + 2.0 * np.tanh(conf) + 0.5 * rng.standard_normal(n_obs)
    return {"tokens": toks, "y": y.astype(np.float32),
            "d": d.astype(np.float32), "theta0": theta}


def encoder_decls():
    def layer():
        return {
            "ln1": PDecl((D,), (None,), init="ones"),
            "attn": attn_decls(ATTN, D),
            "ln2": PDecl((D,), (None,), init="ones"),
            "mlp": {"wi": PDecl((D, 2, 2 * D), ("embed", None, "ff")),
                    "wo": PDecl((2 * D, D), ("ff", "embed"))},
        }
    return {
        "emb": PDecl((VOCAB, D), (None, None), dtype=F32),
        "l0": layer(), "l1": layer(),
        "head": PDecl((D, 1), (None, None), dtype=F32),
    }


def init_params(key, device):
    """The reference's ``init_tree(encoder_decls(), key)`` cast to float32:
    one key a leaf (``split(key, n_leaves)``, leaves in sorted-key order),
    each normal leaf ``normal * 1/sqrt(fan_in)`` (fan_in the next-to-last
    dimension) rounded to its declared type."""
    decls = encoder_decls()
    leaves = tree_leaves(decls)
    keys = threefry.split(key, len(leaves))
    out = []
    for d, k in zip(leaves, keys):
        if d.init == "ones":
            t = torch.ones(d.shape, dtype=d.dtype, device=device)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = float(np.float32(1.0 / np.sqrt(fan_in)))
            t = (threefry.normal(k, d.shape) * scale).to(d.dtype)
        out.append(t.to(F32))
    return tree_unflatten(decls, out)


def encode(params, toks):
    h = F.embedding(toks.long(), params["emb"]).to(torch.bfloat16)
    for lname in ("l0", "l1"):
        lp = params[lname]
        a, _ = attn_forward(lp["attn"], ATTN, rms_norm(h, lp["ln1"]),
                            None, use_rope=True, chunk=1024)
        h = h + a
        m = mlp_forward(lp["mlp"], rms_norm(h, lp["ln2"]), "gelu", True)
        h = h + m
    pooled = torch.mean(h.to(F32), dim=1)
    return (pooled @ params["head"])[:, 0]


def loss_fn(params, toks, y, w):
    pred = encode(params, toks)
    return torch.sum(w * (pred - y) ** 2) / torch.clamp_min(torch.sum(w),
                                                            1.0)


def grads(params, toks, y, w):
    """(loss, gradients as a list in the tree's flattening order)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), toks, y, w)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))


def lm_learner(toks, y, w, params, steps=150, lr=3e-3):
    """One encoder per task, trained from ``params`` (its float32 initial
    weights) by the reference's Adam (no bias correction); its prediction
    on every row."""
    leaves = tree_leaves(params)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    for _ in range(steps):
        _, g = grads(tree_unflatten(params, leaves), toks, y, w)
        with torch.no_grad():
            m = torch._foreach_add(torch._foreach_mul(m, 0.9),
                                   torch._foreach_mul(g, 0.1))
            v = torch._foreach_add(torch._foreach_mul(v, 0.999),
                                   torch._foreach_mul(
                                       torch._foreach_mul(g, g), 0.001))
            step = torch._foreach_div(
                torch._foreach_mul(m, lr),
                torch._foreach_add(torch._foreach_sqrt(v), 1e-8))
            leaves = torch._foreach_sub(leaves, step)
    with torch.no_grad():
        return encode(tree_unflatten(params, leaves), toks)


def run_small(n_obs=300, n_rep=2, n_folds=4, theta=0.5, steps=150, seed=0,
              device="cuda"):
    device = resolve_device(device)
    data = make_text_data(n_obs, theta, seed)
    masks = draw_fold_masks(n_obs, n_folds, n_rep, seed)
    toks = torch.from_numpy(data["tokens"]).to(device)
    targets = {"ml_l": data["y"], "ml_m": data["d"]}
    preds = {k: np.zeros((n_rep, n_folds, n_obs), np.float32)
             for k in targets}
    key = threefry.key(seed, device)
    for mrep in range(n_rep):
        for kf in range(n_folds):
            w = torch.from_numpy((~masks[mrep, kf]).astype(np.float32)
                                 ).to(device)
            for nm, tgt in targets.items():
                key, sub = threefry.split(key)
                preds[nm][mrep, kf] = lm_learner(
                    toks, torch.from_numpy(tgt).to(device), w,
                    init_params(sub, device), steps=steps).cpu().numpy()
    fitted = {nm: stitch_predictions(masks, preds[nm]) for nm in targets}
    pa, pb = plr_score(
        {"y": torch.from_numpy(data["y"]).to(device)[None],
         "d": torch.from_numpy(data["d"]).to(device)[None]},
        {nm: torch.from_numpy(v).to(device) for nm, v in fitted.items()})
    thetas = solve_theta(pa, pb)
    ses = score_se(pa, pb, thetas)
    th, se = aggregate_thetas(thetas, ses)
    return {"theta": th, "se": se, "ci": confint(th, se),
            "theta0": data["theta0"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run_small(device=args.device)
    print(f"theta_hat = {res['theta']:+.4f} (se {res['se']:.4f}), "
          f"CI [{res['ci'][0]:+.3f}, {res['ci'][1]:+.3f}], "
          f"true {res['theta0']}")
