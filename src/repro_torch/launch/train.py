"""Training launcher: ``--arch <id>``.

The port of the reference's ``src/repro/launch/train.py``, with the same
flags and ``--device`` besides (default: the CUDA card; ``--device cpu``
runs it on the host).  ``--local`` trains the arch's reduced (smoke)
config on 8 x 64-token batches; without it the full config on 256 x 4096,
the reference's production shape (one card holds only the smaller archs
at that batch).  Parameters are random, from seed 0; the data is the
synthetic Zipf stream, seed 0:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        --local --steps 20
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.lm import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import Family
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--local", action="store_true",
                    help="run the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.local else get_config(args.arch)
    print(f"arch={cfg.name} params~{cfg.n_params() / 1e6:.0f}M "
          f"active~{cfg.n_active_params() / 1e6:.0f}M device={dev}")

    params = M.init_params(cfg, seed=0, device=dev)
    step = make_train_step(cfg, AdamWConfig(total_steps=args.steps),
                           microbatches=args.microbatches)
    seq = 64 if args.local else 4096
    batch = 8 if args.local else 256
    enc = cfg.d_model if cfg.family == Family.ENCDEC else None
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0, enc_dim=enc,
                       enc_len=seq)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=25,
                         ckpt_dir=args.ckpt_dir)
    out = Trainer(step, init_train_state(params), data, tcfg).run()
    print(out)
    return out


if __name__ == "__main__":
    main()
