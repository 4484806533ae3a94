"""The job that chip_smoke.py's phase 21 submits to its launched cluster.

Joins the cluster at ``--address``, reserves a placement group of one
``{"CPU": 1, "GPU": 1}`` bundle (pending until the autoscaler adds a GPU
node: the group is the demand it sees), starts in it a detached actor
named ``--actor`` that builds GPT-2-small from ``--seed`` and takes
``--steps`` bf16 train steps on the card, prints one JSON line with the
losses and the actor's K1/K2/K3 launches over those steps, and exits 0.
The actor stays, so later work (the phase's workflow) can find it by
name. The job itself runs under its supervisor's worker, which claims no
GPU: this process sees no card and never imports torch.

    python3 chip_job.py --address HOST:PORT --actor NAME --steps N
        --seed S --batch B T
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WAIT_S = 300.0


class JobTrainer:
    """GPT-2-small's train step (chip_smoke's train recipe: bf16 compute,
    f32 masters, adamw(3e-4, weight_decay=0.1), remat) on the card this
    actor's bundle gives it, over a batch drawn from `seed`."""

    def __init__(self, seed: int, batch: tuple):
        t0 = time.perf_counter()
        import torch

        from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss, init_gpt2
        from ray_tpu_torch.train import TrainState, adamw, make_train_step

        import_s = time.perf_counter() - t0
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        torch.ones(1, device="cuda").sum().item()
        context_s = time.perf_counter() - t0 - import_s
        cfg = GPT2Config.small()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        tx = adamw(3e-4, weight_decay=0.1)
        self.state = TrainState.create(init_gpt2(gen, cfg), tx)
        self.step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
        B, T = batch
        toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                             device="cuda")
        self.batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        torch.cuda.synchronize()
        self.info = {"pid": os.getpid(), "import_s": import_s,
                     "context_s": context_s,
                     "init_s": time.perf_counter() - t0 - import_s
                     - context_s,
                     "cuda_visible_devices":
                         os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "device_count": torch.cuda.device_count()}
        self.last = None

    def launches(self) -> dict:
        """This process's launches of K1-K4 so far."""
        from ray_tpu_torch.ops import flash_attention as fa
        from ray_tpu_torch.ops import paged_attention as pa

        return {"flash_fwd": fa.LAUNCHES.count,
                "flash_dq": fa.LAUNCHES_DQ.count,
                "flash_dkv": fa.LAUNCHES_DKV.count,
                "paged_attention": pa.LAUNCHES.count}

    def train(self, steps: int, tokens=None) -> dict:
        """`steps` train steps, on the actor's batch or on `tokens` (a
        (B, T + 1) array of token ids); the losses as host floats and
        the launches over the steps."""
        import torch

        batch = self.batch
        if tokens is not None:
            toks = torch.as_tensor(tokens, device="cuda")
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        before = self.launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            self.state, m = self.step(self.state, batch)
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        after = self.launches()
        self.last = {"pid": os.getpid(), "steps": steps, "losses": losses,
                     "seconds": time.perf_counter() - t0,
                     "launches": {k: after[k] - before[k] for k in after}}
        return self.last

    def last_result(self):
        return self.last

    def start_info(self) -> dict:
        return self.info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_job.py")
    ap.add_argument("--address", required=True)
    ap.add_argument("--actor", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batch", type=int, nargs=2, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import ray_tpu_torch as ray
    from ray_tpu_torch.util.placement_group import (
        PlacementGroupSchedulingStrategy,
        placement_group,
    )

    t0 = time.perf_counter()
    ray.init(address=args.address)
    pg = placement_group([{"CPU": 1.0, "GPU": 1.0}], name=f"{args.actor}-pg")
    if not pg.wait(WAIT_S):
        print(f"chip_job: the placement group was not placed in {WAIT_S} s",
              file=sys.stderr, flush=True)
        return 1
    placed_s = time.perf_counter() - t0
    actor = ray.remote(JobTrainer).options(
        name=args.actor, lifetime="detached", num_cpus=1, num_gpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)).remote(
        args.seed, tuple(args.batch))
    result = ray.get(actor.train.remote(args.steps), timeout=WAIT_S)
    info = ray.get(actor.start_info.remote(), timeout=WAIT_S)
    print(json.dumps({
        "job": "gpt2_train", "actor": args.actor, "pg_id": pg.id.hex(),
        "placed_s": placed_s, "seconds": time.perf_counter() - t0,
        "losses": result["losses"], "launches": result["launches"],
        "train_s": result["seconds"], "actor_start": info,
        "driver_pid": os.getpid(),
        "driver_torch_loaded": "torch" in sys.modules,
        "driver_cuda_visible_devices":
            os.environ.get("CUDA_VISIBLE_DEVICES")}), flush=True)
    ray.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
