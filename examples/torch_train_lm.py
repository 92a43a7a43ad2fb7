"""End-to-end training on the PyTorch/CUDA port: ~100M-param LM for a
few hundred steps.

    python examples/torch_train_lm.py [--steps 200] [--arch ...] \
        [--device cuda|cpu]

The twin of ``examples/train_lm.py`` through ``repro_torch``: the same
CLI, config and printed lines.  Builds a ~100M-parameter variant of an
assigned architecture, streams synthetic token batches, runs the full
train loop (``train/trainer.py fit``: AdamW + cosine + clipping, remat,
atomic checkpoints, restart-safe), and prints losses.  The default
checkpoint directory lies under the temporary directory; an empty
``--ckpt-dir`` writes none.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data.synthetic import token_stream  # noqa: E402
from repro_torch.models.model import param_defs  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.train.trainer import fit  # noqa: E402


def hundred_m_config(arch: str):
    """Scale the assigned config down to ~100M params."""
    cfg = get_config(arch)
    kw = dict(n_layers=8, d_model=512, vocab_size=32_000)
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
                  head_dim=64)
    if cfg.d_ff:
        kw.update(d_ff=2048)
    if cfg.family == "moe":
        kw.update(n_experts=8, moe_top_k=min(cfg.moe_top_k, 2),
                  expert_d_ff=512)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=64, ssm_head_dim=32)
    if cfg.family == "hybrid":
        kw.update(attn_every=4)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=4, enc_seq=64)
    if cfg.family == "vlm":
        kw.update(n_patches=16)
    return cfg.replace(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = hundred_m_config(args.arch)
    n = count_params(param_defs(cfg))
    print(f"arch {args.arch}: ~{n/1e6:.0f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    shape = InputShape("example", args.seq, args.batch, "train")
    report = fit(cfg, shape,
                 token_stream(cfg.vocab_size, args.batch, args.seq, seed=0),
                 args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                 log_every=10, device=args.device)
    print(f"loss: first10={sum(report.losses[:10])/10:.3f} "
          f"last10={sum(report.losses[-10:])/10:.3f}")
    rest = report.step_times[5:]
    print(f"mean step time: "
          f"{sum(rest) / max(len(report.step_times) - 5, 1) * 1e3:.0f} ms")
    print(f"checkpoints in {args.ckpt_dir} (restart-safe: rerun resumes)")


if __name__ == "__main__":
    main()
