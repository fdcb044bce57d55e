"""The NCCL mesh: every visible card, one shard a card.

These need two or more CUDA devices and skip without them (each test
decides inside itself, never while the module is imported).  Run them on
a machine with several cards:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_nccl.py``.
They hold the NCCL route against the simulated mesh of the same shard
count on the first card: the collectives against the ordered sum (1e-6:
NCCL's ring may sum in another order) and ``torch.cat`` (exactly), the
sharded backend's drain bit for bit for ridge (its lanes keep their bits
at any batch count), and K1 and K2 launched on the second card, whose
shared-memory grant is that card's own.  Expert parallelism: the
all-to-all's peer copies, the axis-scoped sum and the reduced MoE layer
on a (1, n) mesh of the cards against the simulated (1, n) mesh.  Tensor
parallelism: the reduced qwen2.5-32b decoder served and trained, and the
reduced VLM served, on a (1, n) mesh of the cards against the simulated
(1, n) mesh.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.core import DMLData, DMLPlan, DMLSession
from repro_torch.data import make_plr_data
from repro_torch.kernels import megabatch, ops
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh, make_sim_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.param import cast_floating, init_tree, shard_params
from repro_torch.serving import grow_cache
from repro_torch.sharding.axes import MEGATRON_FSDP
from repro_torch.serverless import ShardedBackend
from repro_torch.sharding.collectives import (
    mesh_all_to_all, mesh_gather, mesh_sum,
)

pytestmark = pytest.mark.cuda


def _cards() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"the NCCL mesh needs two or more CUDA devices; "
                    f"{n} here")
    return n


def test_nccl_collectives_match_the_simulated_mesh():
    n = _cards()
    mesh = make_host_mesh("cuda")
    assert mesh.collective == "nccl" and len(mesh.shard_devices) == n
    gen = torch.Generator().manual_seed(0)
    host = [torch.randn(4, 6, generator=gen) for _ in range(n)]
    want = host[0]
    for p in host[1:]:
        want = want + p
    summed = mesh_sum([p.to(d) for p, d in zip(host, mesh.devices)], mesh)
    for s, d in zip(summed, mesh.devices):
        assert s.device == d
        torch.testing.assert_close(s.cpu(), want, rtol=1e-6, atol=1e-6)
    for dim in (0, 1):
        gathered = mesh_gather([p.to(d) for p, d in zip(host,
                                                        mesh.devices)],
                               dim, mesh)
        for g in gathered:
            assert torch.equal(g.cpu(), torch.cat(host, dim))


def test_nccl_sharded_drain_is_the_one_device_drain():
    _cards()
    data = DMLData.from_dict(make_plr_data(n_obs=2000, dim_x=20, theta=0.5,
                                           seed=1))
    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0}, n_folds=5,
                             n_rep=10, seed=3)
    nccl = DMLSession(backend=ShardedBackend(mesh=make_host_mesh("cuda")))
    one = DMLSession(backend=ShardedBackend(device="cuda:0"))
    sim = DMLSession(backend=ShardedBackend(
        mesh=make_sim_mesh(len(nccl.backend.mesh.devices), "cuda:0")))
    results = [s.estimate(plan, data) for s in (nccl, one, sim)]
    preds = [s.request(r.request_id).gathered_preds()
             for s, r in zip((nccl, one, sim), results)]
    assert np.isfinite(preds[0]).all()
    for p, r in zip(preds[1:], results[1:]):
        assert np.array_equal(preds[0], p)
        assert results[0].theta == r.theta and results[0].se == r.se


def test_k1_and_k2_launch_on_the_second_card():
    """The first launch on cuda:1 above 48 KB of shared memory opts in
    on that card (csrc/smem_grant.cuh)."""
    _cards()
    for dev in ("cuda:0", "cuda:1"):
        gen = torch.Generator(device=dev).manual_seed(7)
        xs = torch.randn((32, 5104, 33), generator=gen, device=dev)
        w = (torch.rand((32, 5104), generator=gen, device=dev)
             < 0.8).float()
        y = torch.randn((32, 5104), generator=gen, device=dev)
        g, b = ops.batched_gram(xs, w, y)
        g0, b0 = megabatch.batched_gram_plain(xs, w, y)
        torch.testing.assert_close(g, g0, rtol=1e-4,
                                   atol=1e-4 * float(g0.abs().max()))
        torch.testing.assert_close(b, b0, rtol=1e-4,
                                   atol=1e-4 * float(b0.abs().max()))
        beta = torch.randn((32, 33), generator=gen, device=dev)
        out = ops.batched_predict(xs, beta, w)
        torch.testing.assert_close(
            out, megabatch.batched_predict_plain(xs, beta, w), rtol=1e-5,
            atol=1e-5)


def test_nccl_expert_parallel_matches_the_simulated_mesh():
    """A (1, n) mesh of the cards: ``mesh_all_to_all`` (peer copies) and
    the sum over "model" exactly the simulated mesh's, and the reduced
    deepseek-v2-lite MoE layer (a2a and dense_ep) within 1e-5 of it in
    float32."""
    n = _cards()
    cards = tuple(torch.device("cuda", i) for i in range(n))
    mesh = DeviceMesh(cards, (1, n))
    sim = make_sim_mesh((1, n), "cuda:0")
    gen = torch.Generator().manual_seed(1)
    host = [torch.randn(n, 3, 5, generator=gen) for _ in range(n)]
    got = mesh_all_to_all([h.to(d) for h, d in zip(host, cards)], mesh,
                          "model")
    want = mesh_all_to_all([h.to("cuda:0") for h in host], sim, "model")
    for g, w, d in zip(got, want, cards):
        assert g.device == d and torch.equal(g.cpu(), w.cpu())
    summed = mesh_sum([h.to(d) for h, d in zip(host, cards)], mesh,
                      axis="model")
    for s, w in zip(summed, mesh_sum([h.cuda() for h in host], sim,
                                     axis="model")):
        torch.testing.assert_close(s.cpu(), w.cpu(), rtol=1e-6, atol=1e-6)
    cfg = get_arch("deepseek-v2-lite-16b", reduced=True)
    p = cast_floating(init_tree(moe.moe_decls(cfg, n),
                                torch.Generator("cuda:0").manual_seed(0),
                                "cuda:0"), torch.float32)
    for shape in ((2, 128 * n), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen).cuda()
        y, _ = moe.moe_forward(p, cfg, x, mesh=mesh, ep_axis="model")
        y0, _ = moe.moe_forward(p, cfg, x, mesh=sim, ep_axis="model")
        torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)


def test_nccl_tensor_parallel_decoder_matches_the_simulated_mesh():
    """The reduced qwen2.5-32b (2n query heads over n KV heads) on a (1,
    n) mesh of the cards, its leaves placed a block a card: the prefill's
    last logits and two decode steps within 1e-5 of the simulated (1, n)
    mesh's in float32."""
    n = _cards()
    cfg = get_arch("qwen2.5-32b", reduced=True)
    if cfg.vocab_size % n or cfg.d_ff % n:
        pytest.skip(f"the reduced widths do not split over {n} cards")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=2 * n, n_kv_heads=n))
    cards = tuple(torch.device("cuda", i) for i in range(n))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))
    runs = []
    for mesh in (DeviceMesh(cards, (1, n)), make_sim_mesh((1, n), "cuda:0")):
        bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
        params = cast_floating(init_tree(
            bundle.decls, torch.Generator("cuda:0").manual_seed(0),
            "cuda:0"), torch.float32)
        params = shard_params(params, bundle.decls, mesh, MEGATRON_FSDP)
        with torch.inference_mode():
            logits, cache = bundle.prefill_fn(params,
                                              {"tokens": tokens.cuda()})
            steps = [logits.cpu()]
            cache = grow_cache(cfg, cache, 2)
            for _ in range(2):
                tok = steps[-1].argmax(-1)[:, None].to(torch.int32).cuda()
                logits, cache = bundle.decode_fn(params, cache,
                                                 {"tokens": tok})
                steps.append(logits.cpu())
        runs.append(steps)
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_nccl_tensor_parallel_vlm_matches_the_simulated_mesh():
    """The reduced VLM (2n query heads over n KV heads, gates 0.5 and
    -0.7) on a (1, n) mesh of the cards, the cross keys and values
    projected on each card from its copy of the image: the prefill's last
    logits, two decode steps and the joined cache within 1e-5 of the
    simulated (1, n) mesh's in float32."""
    n = _cards()
    cfg = get_arch("llama-3.2-vision-90b", reduced=True)
    if cfg.vocab_size % n or cfg.d_ff % n:
        pytest.skip(f"the reduced widths do not split over {n} cards")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=2 * n, n_kv_heads=n))
    cards = tuple(torch.device("cuda", i) for i in range(n))
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     dtype=torch.int32, generator=gen),
             "img": torch.randn((2, cfg.n_frontend_tokens, cfg.d_frontend),
                                generator=gen)}
    runs = []
    for mesh in (DeviceMesh(cards, (1, n)), make_sim_mesh((1, n), "cuda:0")):
        bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh)
        params = cast_floating(init_tree(
            bundle.decls, torch.Generator("cuda:0").manual_seed(0),
            "cuda:0"), torch.float32)
        params["cross_layers"]["gate"] = torch.tensor(
            [[0.5], [-0.7]], device="cuda:0")
        params = shard_params(params, bundle.decls, mesh, MEGATRON_FSDP)
        with torch.inference_mode():
            logits, cache = bundle.prefill_fn(
                params, {k: v.cuda() for k, v in batch.items()})
            steps = [logits.cpu()]
            cache = grow_cache(cfg, cache, 2)
            for _ in range(2):
                tok = steps[-1].argmax(-1)[:, None].to(torch.int32).cuda()
                logits, cache = bundle.decode_fn(params, cache,
                                                 {"tokens": tok})
                steps.append(logits.cpu())
        runs.append((steps, bundle.join_cache(cache)))
    for got, want in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    for stack in ("self_kv", "cross_kv"):
        got, want = runs[0][1][stack]["k"], runs[1][1][stack]["k"]
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_nccl_mesh_training_matches_the_simulated_mesh():
    """The reduced qwen2.5-32b trained on a (1, n) mesh of the cards:
    the collectives' backwards (``all_reduce`` for a sum, a
    ``reduce_scatter`` for a gather) and the replicas' all-reduce give
    the loss and every joined gradient of the simulated (1, n) mesh
    within 1e-5 in float32, and one placed AdamW step writes every card's
    copy of a replicated block alike."""
    from repro_torch.train import OptConfig, adamw_update, init_opt_state
    from repro_torch.train.optimizer import shard_opt_state
    from repro_torch.train.trainer import reduce_shares, shares_of
    from repro_torch.sharding.collectives import ShardedLeaf
    from repro_torch.models.param import tree_leaves
    n = _cards()
    cfg = get_arch("qwen2.5-32b", reduced=True)
    if cfg.vocab_size % n or cfg.d_ff % n:
        pytest.skip(f"the reduced widths do not split over {n} cards")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=2 * n, n_kv_heads=n))
    cards = tuple(torch.device("cuda", i) for i in range(n))
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                              generator=gen).cuda()
             for k in ("tokens", "targets")}
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for mesh in (DeviceMesh(cards, (1, n)), make_sim_mesh((1, n), "cuda:0")):
        bundle = build_model(cfg, MEGATRON_FSDP, mesh=mesh, remat="full")
        whole = cast_floating(init_tree(
            bundle.decls, torch.Generator("cuda:0").manual_seed(0),
            "cuda:0"), torch.float32)
        params = shard_params(whole, bundle.decls, mesh, MEGATRON_FSDP)
        loss, _, shares = shares_of(bundle.loss_fn, params, batch, mesh)
        grads = reduce_shares(shares, params, mesh)
        state = shard_opt_state(init_opt_state(whole, opt), bundle.decls,
                                mesh, MEGATRON_FSDP)
        params, _, _ = adamw_update(params, grads, state, opt, mesh)
        lnf = params["lnf"]
        if isinstance(lnf, ShardedLeaf):
            for part in lnf.parts[1:]:
                assert torch.equal(part.cpu(), lnf.parts[0].cpu())
        runs.append((float(loss), [
            (g.join() if isinstance(g, ShardedLeaf) else g).cpu()
            for g in tree_leaves(grads)]))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for got, want in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
