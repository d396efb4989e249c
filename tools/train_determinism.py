#!/usr/bin/env python3
"""Whether the fine-tuning step gives the same bits each time it runs on
the card, with and without cuDNN's deterministic algorithms.

    python3 tools/train_determinism.py

Run from the root of a checkout on a machine with a CUDA card. For each
tier (``highest``, ``bf16x3``) and each setting of the flag that
``parallel/training.loss_and_grad`` sets (``_cudnn_deterministic``, or
nothing in its place) it runs 8 steps of the committed recipe's loss and
shapes (M = 16, 512 taps, [4, 1, 8192], cosine lr) three times from the
same bank: eagerly twice (``step.eager``) and once through the CUDA graph
(``step``), and prints the largest difference in the losses and in hk
between the two eager runs and between the graph and the first eager
run, the steps whose loss differs, and each run's ms a step
(``utils.profiling.chained_ms``, CUDA events). It imports no JAX.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_determinism: no CUDA device", file=sys.stderr)
        return 1

    from pqmf_tpu_torch import StreamingPQMF
    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.utils.profiling import chained_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hk = StreamingPQMF(100, 16, device="cpu").params["hk"]
    xs = list(torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 4, 1, 8192)).astype(np.float32)).cuda())
    flag = tt._cudnn_deterministic

    def run(tier, graphed, deterministic):
        tt._cudnn_deterministic = (flag if deterministic
                                   else contextlib.nullcontext)
        try:
            init, step = tt.make_train_step(
                tt.adam(tt.cosine_decay_schedule(2e-5, len(xs))),
                precision=tier, loss_fn=tt.make_finetune_loss(16, 512),
                device="cuda")
            state = init(hk)
            fn = step if graphed else step.eager
            losses = torch.stack([fn(state, x)[1] for x in xs])
            torch.cuda.synchronize()
            ms = chained_ms(lambda v: (fn(state, v), v)[1], xs[0], n=50)
        finally:
            tt._cudnn_deterministic = flag
        return losses, state.hk.detach().clone(), ms

    for tier in ("highest", "bf16x3"):
        for deterministic in (False, True):
            e1 = run(tier, False, deterministic)
            e2 = run(tier, False, deterministic)
            g = run(tier, True, deterministic)
            ee = [(e1[i] - e2[i]).abs().max().item() for i in (0, 1)]
            ge = [(g[i] - e1[i]).abs().max().item() for i in (0, 1)]
            steps = (g[0] != e1[0]).nonzero().flatten().tolist()
            print(f"{tier} deterministic={deterministic}: max|diff| loss / "
                  f"hk eager vs eager {ee[0]:.3g} / {ee[1]:.3g}, graph vs "
                  f"eager {ge[0]:.3g} / {ge[1]:.3g} (steps differing "
                  f"{steps}); ms a step eager {e1[2]:.4f} / {e2[2]:.4f}, "
                  f"graph {g[2]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
