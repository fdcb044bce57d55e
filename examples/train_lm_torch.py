"""End-to-end LM training on the PyTorch/CUDA port — ``examples/train_lm.py``
one for one, with ``repro_torch`` in place of ``repro``: trains a decoder
for a few hundred steps with checkpointing and resume.

The default runs the reduced h2o-danube-3-4b (a CPU-sized config);
``--full-100m`` selects the ~100M config of the reference example (12
layers of 768, vocab 32k; meant for the card).  On the card attention's
forward and backward run the flash-attention kernels (K5).

Run:  python examples/train_lm_torch.py --steps 200 [--device cuda|cpu]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse
import os
import tempfile
from dataclasses import replace

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

from repro_torch.configs import get_arch
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.models import build_model, param_count
from repro_torch.runtime import resolve_device
from repro_torch.train import OptConfig, Trainer, TrainerConfig

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def run(steps: int = 200, full_100m: bool = False,
        ckpt_dir: str = DEFAULT_CKPT_DIR, resume: bool = False,
        device: str = "cuda", log_every: int = 20, ckpt_every: int = 50):
    """Train (or resume) to ``steps``; returns (config, params, optimizer
    state, the logged history, the step it started from)."""
    device = resolve_device(device)
    if full_100m:
        # ~100M decoder: 12L x 768, vocab 32k (GPT-2-small-ish)
        base = get_arch("h2o-danube-3-4b")
        cfg = replace(base, n_layers=12, d_model=768, d_ff=3072,
                      vocab_size=32_000,
                      attention=replace(base.attention, n_heads=12,
                                        n_kv_heads=12, head_dim=64,
                                        sliding_window=None))
        seq, batch = 512, 8
    else:
        cfg = get_arch("h2o-danube-3-4b", reduced=True)
        seq, batch = 128, 8
    bundle = build_model(cfg, remat="none", attn_chunk=min(512, seq))
    print(f"arch={cfg.name} params={param_count(bundle.decls)/1e6:.1f}M "
          f"seq={seq} batch={batch} device={device}")
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, seq, batch, seed=0))
    trainer = Trainer(
        bundle,
        OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps),
        TrainerConfig(steps=steps, log_every=log_every,
                      ckpt_every=ckpt_every, ckpt_dir=ckpt_dir))
    if resume:
        params, opt, start = trainer.resume(device)
        print(f"resumed from step {start}")
    else:
        params, opt = trainer.init(0, device)
        start = 0
    params, opt, hist = trainer.run(params, opt, data.iterate(start),
                                    start_step=start)
    return cfg, params, opt, hist, start


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, _, hist, _ = run(args.steps, args.full_100m, args.ckpt_dir,
                           args.resume, args.device)
    if hist:
        print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
