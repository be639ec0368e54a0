"""WSSL training CLI of the PyTorch port — the twin of
``repro/launch/train.py``.

Runs synchronous WSSL rounds (Algorithm 1 + 2) over the decoder stack —
Gemma-2B, Gemma-3-12B, StableLM-2-12B, Qwen2.5-32B, OLMoE-1B-7B,
Phi-3.5-MoE, Mamba-2-370M or RecurrentGemma-2B — on synthetic LM data,
with random weights from a seed:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --clients 2 --rounds 3 --seq-len 128 --batch-per-client 2

Attention trains through ``--impl`` (default ``dense``, as the JAX
launcher's; ``chunked`` / ``flash`` take the flash path, whose backward
recomputes the probability tiles, ``triangular`` and ``banded`` the
blocked paths of ``models/attention.py``); the recurrent families through
their plain scans, as the JAX package trains them.  The MoE models add
their routers' load-balance aux loss past the client stage, for every
client (selected or not), as the JAX round does.  A Mamba-2 sequence is
at most one SSD chunk or a whole number of chunks; any other length
raises ``ValueError`` (``models/ssm.py::ssd_chunked``) where JAX asserts.

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead
(with ``--reduced`` for a size the CPU can take).  ``--checkpoint PATH``
saves the trained stages ``{"client_stack", "server"}`` in the JAX
launcher's format (``checkpoint/io.py``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import (ModelConfig, TrainConfig, WSSLConfig,
                                get_arch, reduced)
from repro_torch.core.round import WSSLState, init_state, make_round_fn
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.layers import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="gemma-2b | gemma3-12b | stablelm-12b | "
                         "qwen2.5-32b | olmoe-1b-7b | phi3.5-moe-42b-a6.6b | "
                         "mamba2-370m | recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--val-batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--impl", default="dense",
                    help="attention implementation: dense | chunked | flash "
                         "| triangular | banded")
    ap.add_argument("--client-chunk", type=int, default=None,
                    help="per-client forward/backward in chunks of this many "
                         "clients (must divide --clients)")
    ap.add_argument("--fused-adam", action="store_true",
                    help="accepted for parity with the JAX launcher; AdamW "
                         "always takes the fused masked-AdamW kernel on the "
                         "card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="save the trained stages to this .npz path")
    ap.add_argument("--log", default=None, help="write the history as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    return ap.parse_args(argv)


def make_configs(args: argparse.Namespace
                 ) -> Tuple[ModelConfig, WSSLConfig, TrainConfig]:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    wssl_cfg = WSSLConfig(num_clients=args.clients,
                          participation_fraction=args.participation)
    train_cfg = TrainConfig(rounds=args.rounds, learning_rate=args.lr,
                            remat=not args.reduced, fused_adam=args.fused_adam,
                            client_chunk=args.client_chunk)
    return cfg, wssl_cfg, train_cfg


def round_batch(cfg: ModelConfig, n: int, b: int, s: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """One round's client batch: tokens/labels (n, b, s) on ``device``."""
    d = lm_batch(n * b, s, cfg.vocab_size, seed=seed)
    return {k: torch.as_tensor(v.reshape(n, b, s), device=device)
            for k, v in d.items()}


def train(cfg: ModelConfig, wssl_cfg: WSSLConfig, train_cfg: TrainConfig, *,
          rounds: int, batch_per_client: int, seq_len: int, val_batch: int,
          seed: int = 0, device="cuda", impl: str = "dense",
          gumbels: Optional[Sequence[torch.Tensor]] = None,
          before_round: Optional[Callable[[WSSLState, int], None]] = None,
          log: Callable[[str], None] = print
          ) -> Tuple[WSSLState, List[dict]]:
    """Init the state from ``seed`` and run ``rounds`` rounds; returns the
    state and one record per round.  Each round's time ends in a device
    synchronise.  ``gumbels`` replaces the selection draw of each round;
    ``before_round(state, r)``, when given, reads the state before round r
    (outside the round's time)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_state(gen, cfg, wssl_cfg, train_cfg, device=device)
    round_fn = make_round_fn(cfg, wssl_cfg, train_cfg, impl=impl)
    n, b, s = wssl_cfg.num_clients, batch_per_client, seq_len
    vd = lm_batch(val_batch, s, cfg.vocab_size, seed=10_000)
    val = {k: torch.as_tensor(v, device=device) for k, v in vd.items()}

    history = []
    for r in range(rounds):
        batch = round_batch(cfg, n, b, s, seed * 1000 + r, device)
        if before_round is not None:
            before_round(state, r)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = round_fn(state, batch, val,
                            gumbel=None if gumbels is None else gumbels[r])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rec = {"round": r, "loss": float(m.loss), "dt_s": dt,
               "selected": int(m.mask.sum()),
               "mask": m.mask.cpu().tolist(),
               "mean_val_loss": float(m.val_loss.mean()),
               "val_loss": m.val_loss.cpu().tolist(),
               "importance": np.asarray(m.importance.cpu()).round(4).tolist(),
               "bytes_up_MB": float(m.bytes_up) / 1e6}
        history.append(rec)
        log(f"round {r:3d}  loss={rec['loss']:.4f}  "
            f"val={rec['mean_val_loss']:.4f}  sel={rec['selected']}  "
            f"up={rec['bytes_up_MB']:.1f}MB  {dt:.1f}s")
    return state, history


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg, wssl_cfg, train_cfg = make_configs(args)
    device = resolve_device(args.device)
    print(f"device={device.type} arch={cfg.name} clients={args.clients}")
    state, history = train(cfg, wssl_cfg, train_cfg, rounds=args.rounds,
                           batch_per_client=args.batch_per_client,
                           seq_len=args.seq_len, val_batch=args.val_batch,
                           seed=args.seed, device=device, impl=args.impl)
    if args.checkpoint:
        save_checkpoint(args.checkpoint,
                        {"client_stack": state.client_stack,
                         "server": state.server_params},
                        metadata={"arch": args.arch, "rounds": args.rounds})
        print("checkpoint ->", args.checkpoint)
    if args.log:
        with open(args.log, "w") as f:
            json.dump(history, f, indent=2)


if __name__ == "__main__":
    main()
