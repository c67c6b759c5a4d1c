"""The paper's FedAvg schedule as a cross-pod LLM training strategy, in the
PyTorch port: the counterpart of ``examples/llm_local_sgd.py``.

Runs a REDUCED qwen-family decoder as 2 pod replicas in one process with
DiLoCo-style local SGD: H inner steps per pod with no cross-pod sync, then
one FedAvg parameter average across pods.  Loss decreases and the two pod
replicas re-converge at every sync: FedAvg is local SGD with an H-step
communication period.  It runs on the CUDA card unless given ``--device
cpu``.

  PYTHONPATH=src python examples/torch_llm_local_sgd.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.launch import lm_steps
from repro_torch.models import transformer as tf
from repro_torch.serving.registry import resolve_device

H = 4                # inner steps between cross-pod syncs
ROUNDS = 3
B, S = 8, 64
N_POD = 2
LR = 3e-3


def run(device, rounds: int = ROUNDS, params=None, seed: int = 0):
    """``rounds`` local-SGD rounds from ``params`` (fp32; default: seeded
    on ``device``).  Each round draws its tokens from one numpy stream
    (seed 0), as the JAX example does.  Returns (each round's pod losses
    (N_POD, H) and pre-sync drift, the stacked params)."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    if params is None:
        gen = torch.Generator(device).manual_seed(seed)
        params = tf.init_model(gen, cfg, dtype=torch.float32)
    opt = optim.adam()
    step = tf.make_train_step(cfg, opt, dtype=torch.float32)
    params_p = lm_steps.stack_pods(params, N_POD)
    opt_p = lm_steps.stack_pods(opt.init(params), N_POD)
    rng = np.random.default_rng(0)
    history = []
    for _ in range(rounds):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (N_POD, H, B, S))).to(device)
        losses, drift = lm_steps.local_sgd_round(
            step, params_p, opt_p, {"tokens": toks, "labels": toks}, LR)
        history.append((losses.cpu().numpy(), float(drift)))
    return history, params_p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    history, _ = run(resolve_device(args.device))
    for r, (losses, drift) in enumerate(history):
        print(f"round {r}: pod0 losses {np.round(losses[0], 3)}  "
              f"pod1 losses {np.round(losses[1], 3)}  "
              f"pre-sync param drift {drift:.3f}")
    print("pods trained independently for H steps, then FedAvg re-synced "
          "them -\ncross-pod traffic is 1/H of per-step synchronization.")


if __name__ == "__main__":
    main()
