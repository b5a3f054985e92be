"""How far a resumed training run parts from the original on the card, against how far two
resumed runs part from each other: the measurement behind the resume check of
``chip_smoke.py``'s "stoch" phase.

Each run is that phase once (``nerf_hash_lego_proxy_stoch.yaml`` as shipped but for 4 views:
25 steps, a train-state save, two trainers resumed from it, 5 steps of each and of the
original), and prints one JSON line: the codebook entries in which the original parts from
the first resumed trainer by more than 1e-5 of its largest entry, the same count between the
two resumed trainers, the largest differences, the losses' largest relative difference, and
the checks that failed. ``--lose`` runs a resume that leaves the random stream
('generator') or the optimizer's state ('optimizer') as built, to show what a broken resume
looks like to the same counts.

    python3 chip_resume_drift.py --runs 6
    python3 chip_resume_drift.py --lose generator,optimizer
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6, help="sound resumes to run")
    ap.add_argument("--lose", default="", help="comma-separated: generator, optimizer")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_resume_drift: no CUDA device", file=sys.stderr)
        return 1
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.trainers import base_trainer
    print(chip_smoke.nvidia_smi_line(), flush=True)
    kernels.build()
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False

    failed = []
    chip_smoke.require = lambda cond, msg: None if cond else failed.append(msg)
    real_load = base_trainer.BaseTrainer.load_state

    def losing(what):
        def load_state(self, state):
            real_load(self, state)
            if what == "generator":
                self.generator.manual_seed(12345)
            else:
                self.optimizer.state.clear()
        return load_state

    modes = [m for m in args.lose.split(",") if m] + ["sound"] * args.runs
    for mode in modes:
        if mode not in ("sound", "generator", "optimizer"):
            raise SystemExit(f"unknown --lose {mode!r}")
        base_trainer.BaseTrainer.load_state = real_load if mode == "sound" else losing(mode)
        t0 = time.perf_counter()
        _, info = chip_smoke.stoch_phase(torch.device("cuda"))
        out = {"resume": mode, "s": time.perf_counter() - t0,
               "failed": [m[:160] for m in failed]}
        out.update({k: v for k, v in info.items()
                    if k.startswith("resume_") and k != "resume_losses"})
        print(json.dumps(out), flush=True)
        failed.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
