"""Batched serving on the PyTorch/CUDA port — ``examples/serve_lm.py`` one
for one, with ``repro_torch`` in place of ``repro``: prefill + KV-cache
decode with slot-based continuous batching over a request queue, on a
reduced model with random weights drawn from a seed.

The default architecture is the reference example's, deepseek-v2-lite-16b
(MoE with latent attention: its prefill attends with q and k at depth 48
against v at 32 in the reduced model, and decodes against the latent
cache).  On the card its prefills run the flash-attention kernel.  Every
name of the registry is taken.  The reduced xlstm-350m has no block
(slstm_every 8 at 4 layers, as in the reference): embedding, norm and
unembedding only.  whisper-base and llama-3.2-vision-90b need their frames
or image patches beside the tokens, which ``serve_requests`` does not pass
(nor does the reference's): for them the queue is not served, and the
batch goes through ``generate`` with frames or patches drawn from a seed.

Run:  python examples/serve_lm_torch.py [--arch NAME] [--device cuda|cpu]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model, init_tree
from repro_torch.runtime import resolve_device
from repro_torch.serving import Engine


def run(arch: str = "deepseek-v2-lite-16b", requests: int = 10,
        batch: int = 4, prompt_len: int = 48, gen: int = 12,
        device: str = "cuda", params=None):
    """Serve ``requests`` random prompts on the reduced ``arch``, then one
    batch of ``batch`` prompts through ``generate``.  ``params`` (a tree
    of tensors on ``device``) replaces the seeded draw.  Returns (config,
    prompts, the served tokens, the batch's ``GenResult``)."""
    device = resolve_device(device)
    cfg = get_arch(arch, reduced=True)
    bundle = build_model(cfg, attn_chunk=32)
    if params is None:
        gen_ = torch.Generator(device=device).manual_seed(0)
        params = init_tree(bundle.decls, gen_, device)
    engine = Engine(bundle, params, device=device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(8, prompt_len)))
               .astype(np.int32) for _ in range(requests)]
    toks = np.stack([np.resize(p, prompt_len) for p in prompts[:batch]])
    side = _side_inputs(cfg, len(toks), prompt_len)
    outs = [] if side else engine.serve_requests(prompts, batch, prompt_len,
                                                 n_gen=gen)
    res = engine.generate({"tokens": toks, **side}, n_gen=gen)
    return cfg, prompts, outs, res


def _side_inputs(cfg, batch: int, prompt_len: int):
    """The inputs beside the tokens that the family's prefill takes, drawn
    from a seed: whisper's frames (batch, prompt_len, d_frontend), as its
    input specs shape them, and the VLM's image patches (batch, image
    tokens, d_frontend); none for the others."""
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, prompt_len, cfg.d_frontend), dtype=np.float32)}
    if cfg.family == "vlm":
        return {"img": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_frontend), dtype=np.float32)}
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, prompts, outs, res = run(args.arch, args.requests, args.batch,
                                  args.prompt_len, args.gen, args.device)
    print(f"serving reduced {cfg.name} "
          f"({'MLA latent cache' if cfg.attention.is_mla else 'GQA KV cache'})")
    for i in range(min(3, len(outs))):
        print(f"  req{i}: prompt[{len(prompts[i])}] -> {outs[i]}")
    print(f"\nbatch={args.batch}: prefill {res.prefill_s*1e3:.0f} ms, "
          f"decode {res.decode_s*1e3:.0f} ms, {res.tokens_per_s:.1f} tok/s")
    return outs, res


if __name__ == "__main__":
    main()
