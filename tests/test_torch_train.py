"""The port's optimizer, checkpoints and trainer (``repro_torch.train``)
against the JAX package's, on the CPU: the nine cases of
``tests/test_train.py``, each run on both sides, and the cross-package
checks.

Inputs come from numpy with a seed and reach both sides as the same
arrays.  Tiers: ``schedule`` within 1 float32 ulp (XLA's and PyTorch's
cosine); ``adamw_update`` on the same gradients within rtol 1e-6, atol
1e-7 in float32 over three steps (``b ** step`` and the square root are
the two libraries' own); ``compress_int8``'s codes exactly (both round half
to even); checkpoints across the packages bit for bit, bfloat16 leaves
included; the trainers' loss curves, from the same parameters and tokens,
within the measured tier ``CURVE_TIER``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro_torch.configs import get_arch
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.param import tree_leaves, tree_map, tree_paths
from repro_torch.train import (
    Checkpointer, OptConfig, Trainer, TrainerConfig, adamw_update,
    init_opt_state, make_train_step, schedule,
)
from repro_torch.train.checkpoint import payload_to_tree, tree_to_payload
from repro_torch.train.optimizer import compress_int8, global_norm

# the trainers' losses from the same parameters and tokens (reduced
# h2o-danube-3-4b, bf16 parameters, batch 4 x 32): measured up to 8.5e-3
# relative over 15 steps, every step logged (bf16 rounds products and
# updates at other places in the two libraries, and Adam turns such
# differences into steps of lr), held at 2e-2
CURVE_TIER = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jcfg(cfg: OptConfig):
    return JO.OptConfig(**cfg.__dict__)


# ---------------------------------------------------------------- schedule
def test_schedule_warmup_and_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1)
    jcfg = _jcfg(cfg)
    for sched, arr in ((lambda t: float(schedule(cfg, torch.tensor(t))),
                        None),
                       (lambda t: float(JO.schedule(jcfg, jnp.asarray(t))),
                        None)):
        assert sched(0) == 0.0
        assert abs(sched(10) - 1.0) < 1e-6
        assert sched(5) == pytest.approx(0.5)
        assert sched(110) == pytest.approx(0.1, abs=1e-6)
        assert sched(60) > sched(100)


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def test_schedule_within_one_ulp_of_reference():
    """Warmup within 1 ulp; the cosine part within 1 ulp of lr (the two
    libraries' cosines differ by up to 1 ulp, and 1 + cos cancels near
    the end of the decay: there 1 ulp of the cosine is up to 5 ulps of
    the rate, measured)."""
    cfg = OptConfig(lr=3e-4, warmup_steps=17, total_steps=500)
    steps = np.arange(0, 600, dtype=np.int32)
    got = schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(JO.schedule(_jcfg(cfg), jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    warm = steps < cfg.warmup_steps
    assert _ulps(got[warm], want[warm]).max() <= 1
    one_ulp_of_lr = np.spacing(np.float32(cfg.lr))
    assert np.abs(got - want).max() <= one_ulp_of_lr
    prog = np.clip((steps.astype(np.float32) - 17) / np.float32(483), 0, 1)
    cos_t = torch.cos(np.pi * torch.from_numpy(prog)).numpy()
    cos_j = np.asarray(jnp.cos(jnp.pi * jnp.asarray(prog)))
    assert _ulps(cos_t, cos_j).max() <= 1


# ---------------------------------------------------------------- AdamW
def test_adamw_converges_on_quadratic():
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=1e9)
    target_np = np.asarray([[1.0, -2.0], [3.0, 0.5]], np.float32)
    # the port
    target = torch.from_numpy(target_np)
    params = {"w": torch.zeros((2, 2), dtype=torch.bfloat16)}
    state = init_opt_state(params, cfg)
    for _ in range(300):
        g = {"w": state["master"]["w"] - target}
        params, state, m = adamw_update(params, g, state, cfg)
    assert float((state["master"]["w"] - target).abs().max()) < 0.05
    assert params["w"].dtype == torch.bfloat16
    # the reference
    jcfg = _jcfg(cfg)
    jp = {"w": jnp.zeros((2, 2), jnp.bfloat16)}
    js = JO.init_opt_state(jp, jcfg)
    for _ in range(300):
        g = {"w": js["master"]["w"] - jnp.asarray(target_np)}
        jp, js, _ = JO.adamw_update(jp, g, js, jcfg)
    assert float(jnp.max(jnp.abs(js["master"]["w"] - target_np))) < 0.05
    np.testing.assert_allclose(_np(state["master"]["w"]),
                               _np(js["master"]["w"]), atol=1e-5)


def test_grad_clipping_bounds_update():
    cfg = OptConfig(lr=1.0, warmup_steps=0, total_steps=10, clip_norm=1.0,
                    weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    _, state, m = adamw_update(params, {"w": torch.full((4,), 1e6)},
                               init_opt_state(params, cfg), cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    jcfg = _jcfg(cfg)
    jp = {"w": jnp.zeros((4,), jnp.float32)}
    _, js, jm = JO.adamw_update(jp, {"w": jnp.full((4,), 1e6)},
                                JO.init_opt_state(jp, jcfg), jcfg)
    assert float(jm["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    # post-clip the moments are the same bounded values on both sides
    np.testing.assert_allclose(_np(state["m"]["w"]), _np(js["m"]["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference(compress):
    """Three steps of the same gradients through both packages: float32
    master, moments and new bf16 parameters within the float tier; the
    global norm, the learning rate and the step equal."""
    rng = np.random.default_rng(5 + compress)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4, 2)}}
    p0 = tree_map(lambda s: rng.standard_normal(s, dtype=np.float32), shapes)
    grads = [tree_map(lambda s: rng.standard_normal(s, dtype=np.float32)
                      * 3.0, shapes) for _ in range(3)]
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    compress_grads=compress, clip_norm=2.0)
    jcfg = _jcfg(cfg)
    params = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p0)
    state = init_opt_state(params, cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p0)
    js = JO.init_opt_state(jp, jcfg)
    for g in grads:
        params, state, m = adamw_update(
            params, tree_map(torch.from_numpy, g), state, cfg)
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     jcfg)
        assert float(m["lr"]) == float(jm["lr"])
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
    assert int(state["step"]) == int(js["step"]) == 3
    keys = ("master", "m", "v") + (("err",) if compress else ())
    for key in keys:
        for (path, got) in tree_paths(state[key]):
            want = js[key]
            for k in path:
                want = want[k]
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} {path}")
    for (path, got) in tree_paths(params):
        want = jp
        for k in path:
            want = want[k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), rtol=8e-3)


def test_compress_int8_codes_match_reference_exactly():
    """The same float32 input gives the same int8 codes (half to even) and
    the same dequantized values and error on both sides."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((64, 64)).astype(np.float32)
    g[0, :8] = np.float32(127.0) * np.arange(8) / 254.0 * 2 * 0.5
    err = (rng.standard_normal((64, 64)) * 1e-3).astype(np.float32)
    deq, new_err = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    jdeq, jerr = JO.compress_int8(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))


def test_compress_int8_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(64, 64)).astype(np.float32)
    g = torch.from_numpy(g_np)
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    jerr = jnp.zeros_like(jnp.asarray(g_np))
    jtotal = jnp.zeros_like(jerr)
    for _ in range(30):
        deq, err = compress_int8(g, err)
        total = total + deq
        jdeq, jerr = JO.compress_int8(jnp.asarray(g_np), jerr)
        jtotal = jtotal + jdeq
    np.testing.assert_allclose((total / 30).numpy(), g_np, atol=0.02)
    np.testing.assert_allclose(np.asarray(jtotal / 30), g_np, atol=0.02)
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))


def test_compressed_training_matches_uncompressed_approximately():
    target = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)

    def train(compress, port):
        cfg = OptConfig(lr=0.05, warmup_steps=0, total_steps=300,
                        weight_decay=0.0, clip_norm=1e9,
                        compress_grads=compress)
        if port:
            t = torch.from_numpy(target)
            params = {"w": torch.zeros((8, 8))}
            state = init_opt_state(params, cfg)
            for _ in range(300):
                g = {"w": state["master"]["w"] - t}
                params, state, _ = adamw_update(params, g, state, cfg)
            return float((state["master"]["w"] - t).abs().mean())
        jcfg = _jcfg(cfg)
        params = {"w": jnp.zeros((8, 8), jnp.float32)}
        state = JO.init_opt_state(params, jcfg)
        for _ in range(300):
            g = {"w": state["master"]["w"] - target}
            params, state, _ = JO.adamw_update(params, g, state, jcfg)
        return float(jnp.mean(jnp.abs(state["master"]["w"] - target)))

    for port in (True, False):
        assert train(True, port) < 0.1
        assert abs(train(True, port) - train(False, port)) < 0.05
    assert train(True, True) == pytest.approx(train(True, False), abs=1e-4)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    got = float(global_norm(tree_map(torch.from_numpy, tree)))
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- checkpoints
def _tree(rng):
    return {
        "a": rng.normal(size=(3, 5)).astype(np.float32),
        "b": {"c": np.arange(7, dtype=np.int32),
              "d": rng.normal(size=(2, 4)).astype(np.float32)},
    }


def test_checkpoint_roundtrip_bf16():
    rng = np.random.default_rng(0)
    t = _tree(rng)
    tree = {"a": torch.from_numpy(t["a"]).to(torch.bfloat16),
            "b": {"c": torch.from_numpy(t["b"]["c"])}}
    back = payload_to_tree(tree_to_payload(tree), tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    jtree = {"a": jnp.asarray(t["a"], jnp.bfloat16),
             "b": {"c": jnp.asarray(t["b"]["c"])}}
    jback = JC.payload_to_tree(JC.tree_to_payload(jtree), jtree)
    for x, y in zip(jax.tree.leaves(jtree), jax.tree.leaves(jback)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


def test_checkpoint_payloads_are_the_same_bytes():
    """The same tree gives the same payload in both packages (keys,
    dtype names, shapes and bytes), bfloat16 included."""
    rng = np.random.default_rng(1)
    t = _tree(rng)
    jtree = {"a": jnp.asarray(t["a"], jnp.bfloat16),
             "b": {"c": jnp.asarray(t["b"]["c"]),
                   "d": jnp.asarray(t["b"]["d"])},
             "step": jnp.asarray(3, jnp.int32)}
    ptree = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    assert tree_to_payload(ptree) == JC.tree_to_payload(jtree)


def _like_both(t):
    jlike = {"a": jnp.zeros((3, 5), jnp.bfloat16),
             "b": {"c": jnp.zeros(7, jnp.int32),
                   "d": jnp.zeros((2, 4), jnp.float32)}}
    plike = {"a": torch.zeros((3, 5), dtype=torch.bfloat16),
             "b": {"c": torch.zeros(7, dtype=torch.int32),
                   "d": torch.zeros((2, 4))}}
    return jlike, plike


def test_checkpoints_restore_across_packages_bit_for_bit(tmp_path):
    """A checkpoint the reference writes restores in the port, and one the
    port writes in the reference: params, optimizer state (with its int32
    step) and extra, bit for bit."""
    rng = np.random.default_rng(2)
    t = _tree(rng)
    jparams = {"a": jnp.asarray(t["a"], jnp.bfloat16),
               "b": {"c": jnp.asarray(t["b"]["c"]),
                     "d": jnp.asarray(t["b"]["d"])}}
    jcfg = JO.OptConfig()
    jopt = JO.init_opt_state(jparams, jcfg)
    jopt["step"] = jnp.asarray(12, jnp.int32)
    JC.Checkpointer(str(tmp_path / "ref"), async_write=False).save(
        12, jparams, jopt, extra={"data_step": 12})
    jlike, plike = _like_both(t)
    ck = Checkpointer(str(tmp_path / "ref"), async_write=False)
    p, o, step, extra = ck.restore(plike, init_opt_state(plike, OptConfig()))
    assert step == 12 and extra == {"data_step": 12}
    want = params_from_numpy(jax.tree.map(np.asarray, {"p": jparams,
                                                        "o": jopt}), "cpu")
    for got, w in zip(tree_leaves({"p": p, "o": o}), tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w)

    # and back: the port writes, the reference restores
    ck2 = Checkpointer(str(tmp_path / "port"), async_write=False)
    ck2.save(13, p, o, extra={"data_step": 13})
    jp2, jo2, step2, extra2 = JC.Checkpointer(str(tmp_path / "port")).restore(
        jlike, JO.init_opt_state(jlike, jcfg))
    assert step2 == 13 and extra2 == {"data_step": 13}
    for got, w in zip(jax.tree.leaves({"p": jp2, "o": jo2}),
                      jax.tree.leaves({"p": jparams, "o": jopt})):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(got)).view(np.uint8),
            np.atleast_1d(np.asarray(w)).view(np.uint8))


def test_checkpointer_gc_and_restore(tmp_path):
    for port in (True, False):
        d = str(tmp_path / ("port" if port else "ref"))
        if port:
            ck = Checkpointer(d, keep=2, async_write=False)
            params = {"w": torch.ones((2,))}
            opt = {"step": torch.zeros((), dtype=torch.int32)}
            for s in (10, 20, 30, 40):
                ck.save(s, {"w": params["w"] * s}, opt,
                        extra={"data_step": s})
            first = lambda p: float(p["w"][0])   # noqa: E731
        else:
            ck = JC.Checkpointer(d, keep=2, async_write=False)
            params = {"w": jnp.ones((2,), jnp.float32)}
            opt = {"step": jnp.zeros((), jnp.int32)}
            for s in (10, 20, 30, 40):
                ck.save(s, jax.tree.map(lambda x: x * s, params), opt,
                        extra={"data_step": s})
            first = lambda p: float(p["w"][0])   # noqa: E731
        assert ck.steps() == [30, 40]
        p, o, step, extra = ck.restore(params, opt)
        assert step == 40 and extra["data_step"] == 40
        assert first(p) == 40.0
        p, o, step, _ = ck.restore(params, opt, step=30)
        assert first(p) == 30.0


def test_checkpointer_writes_from_a_thread(tmp_path):
    """The default writer: save returns after the host copy, wait() joins
    the writer, the file appears whole under its final name."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"w": torch.arange(4.0)}, {"step": torch.tensor(5)})
    ck.wait()
    assert ck.steps() == [5]
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["ckpt_00000005.msgpack"]


# ---------------------------------------------------------------- trainer
def _h2o_reduced():
    cfg = get_arch("h2o-danube-3-4b", reduced=True)
    return cfg, build_model(cfg, remat="none", attn_chunk=32)


def _jax_params(cfg_name="h2o-danube-3-4b"):
    from repro.configs import get_arch as jax_get_arch
    from repro.models import build_model as jax_build_model
    from repro.models import init_tree as jax_init_tree
    jb = jax_build_model(jax_get_arch(cfg_name, reduced=True), remat="none",
                         attn_chunk=32)
    return jb, jax_init_tree(jb.decls, jax.random.key(0))


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """The reference's case on the port (parameters from a torch seed),
    and the two trainers from the same parameters and tokens: their
    losses at the logged steps within CURVE_TIER."""
    cfg, bundle = _h2o_reduced()
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, 32, 4, seed=0))
    ocfg = OptConfig(lr=5e-3, warmup_steps=2, total_steps=20)
    tr = Trainer(bundle, ocfg,
                 TrainerConfig(steps=15, log_every=5, ckpt_every=5,
                               ckpt_dir=str(tmp_path / "port")))
    params, opt = tr.init(0, device="cpu")
    params, opt, hist = tr.run(params, opt, data.iterate())
    assert hist[-1]["loss"] < hist[0]["loss"]
    p2, o2, s2 = tr.resume(device="cpu")
    assert s2 == 15
    for a, b in zip(tree_leaves({"p": params, "o": opt}),
                    tree_leaves({"p": p2, "o": o2})):
        assert a.dtype == b.dtype and torch.equal(a, b)

    # both packages from the reference's parameters
    from repro.data.lm_data import LMDataConfig as JDataConfig
    from repro.data.lm_data import SyntheticLM as JSyntheticLM
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    jb, jp = _jax_params()
    # first: the reference's run donates its parameters
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jtr = JTrainer(jb, _jcfg(ocfg), JTrainerConfig(steps=15, log_every=5))
    jdata = JSyntheticLM(JDataConfig(cfg.vocab_size, 32, 4, seed=0))
    _, _, jhist = jtr.run(jp, JO.init_opt_state(jp, _jcfg(ocfg)),
                          jdata.iterate())
    tr2 = Trainer(bundle, ocfg, TrainerConfig(steps=15, log_every=5))
    _, _, phist = tr2.run(pp, init_opt_state(pp, ocfg), data.iterate())
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    for got, want in zip(phist, jhist):
        assert abs(got["loss"] - want["loss"]) <= CURVE_TIER * want["loss"], \
            (got["step"], got["loss"], want["loss"])


def test_trainer_init_defaults_to_the_card():
    """``Trainer.init`` runs on the card unless asked for the CPU: on a
    machine without one it raises (nothing falls back)."""
    _, bundle = _h2o_reduced()
    tr = Trainer(bundle, OptConfig(), TrainerConfig())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.init(0)


def test_microbatch_equals_full_batch_gradients():
    """Two microbatches against one batch from the same parameters: the
    parameters after a step track closely on the port, as on the
    reference; and the port's one-batch step tracks the reference's."""
    cfg, bundle = _h2o_reduced()
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, 32, 4, seed=0))
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jb, jp = _jax_params()
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    p1, _, m1 = make_train_step(bundle, ocfg, 1)(
        pp, init_opt_state(pp, ocfg), batch)
    p2, _, m2 = make_train_step(bundle, ocfg, 2)(
        pp, init_opt_state(pp, ocfg), batch)
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-2
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-2)

    from repro.train.trainer import make_train_step as jax_make_train_step
    jbatch = jax.tree.map(jnp.asarray, data.batch(0))
    jcfg = _jcfg(ocfg)
    jp1, _, jm1 = jax.jit(jax_make_train_step(jb, jcfg, 1))(
        jp, JO.init_opt_state(jp, jcfg), jbatch)
    assert float(m1["loss"]) == pytest.approx(float(jm1["loss"]), rel=1e-2)
    d = max(float(np.abs(_np(a) - np.asarray(b, np.float32)).max())
            for a, b in zip(tree_leaves(p1),
                            [x for _, x in sorted(
                                _flat(jp1).items())]))
    assert d < 5e-2


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_checkpointer_reports_a_failed_write(tmp_path):
    """A write that fails in the writer thread raises from wait() (and so
    from the next save), not only on the thread's stderr."""
    ck = Checkpointer(str(tmp_path / "ckpt"))
    (tmp_path / "ckpt").rmdir()
    ck.save(1, {"w": torch.zeros(2)}, {"step": torch.tensor(1)})
    with pytest.raises(FileNotFoundError):
        ck.wait()
    ck.wait()                               # reported once
