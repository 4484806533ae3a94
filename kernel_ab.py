#!/usr/bin/env python3
"""Time the port's attention kernels of several checkouts in turns, in
one run on one card, on the same seeded inputs.

    python3 kernel_ab.py build/parent . . build/parent

Each argument is the root of a checkout holding ``ray_tpu_torch/``. The
trees are timed one after another, each in a subprocess of its own that
imports that tree's package (and builds its kernels into that tree's
``build/``), in the order given, so that two versions alternate on one
card. Timed, all in bf16 with H=12, D=64: K1 (flash forward), K2 (dq)
and K3 (dk, dv) at the training shape B=8 T=1024 causal on q, k, v as
column slices of one qkv projection; K4 (paged attention, W=1,
block_size 16, 1024-token tables) at the decode batch of chip_smoke.py
(contexts 0 to 1023), at one request of 1023 cached tokens, and at
eight of them. Each time is the mean over a replayed CUDA graph of many
calls (chip_smoke.cuda_ms). Prints one JSON line per tree, kernel and
shape, then the card's name and power limit and one summary line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PAGED_SHAPES = {"decode_batch": None, "one_long": (1023,),
                "eight_long": (1023,) * 8}


def time_tree(tree: str) -> list[dict]:
    """The kernels of `tree`'s ray_tpu_torch, timed in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    # this script's chip_smoke.py (its timing and inputs), whichever tree
    # is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ray_tpu_torch import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    _build.build_all()  # every library at once, not one per first call
    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    B, T, H, D, scale = 8, 1024, 12, 64, 0.125
    qkv = torch.randn((B, T, 3 * H * D), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16()
    o, lse = fa._fwd(q, k, v, True, scale)
    delta = fa._delta(o, do)
    shape = {"B": B, "T": T, "H": H, "D": D, "causal": True}
    for name, fn in (
            ("flash_fwd", lambda: fa._fwd(q, k, v, True, scale)),
            ("flash_dq", lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                               True, scale)),
            ("flash_dkv", lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                 True, scale))):
        rows.append({"kernel": name, "shape": shape,
                     "ms": cs.cuda_ms(torch, fn, 20)})
    for label, ctx in PAGED_SHAPES.items():
        ctx = ctx or cs.PAGED_CTX
        args = cs.paged_inputs(torch, gen, torch.bfloat16, ctx, 12, 12, 1,
                               16, 64)
        rows.append({"kernel": "paged_attention", "shape": label,
                     "ctx_len": list(ctx),
                     "ms": cs.cuda_ms(torch, lambda: pa.paged_attention(
                         *args), 100)})
    return rows


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        for row in time_tree(sys.argv[2]):
            print(json.dumps(row), flush=True)
        return 0
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=False)
    times: dict[str, dict[str, list[float]]] = {}
    for i, tree in enumerate(trees):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True,
                             timeout=1200, check=False)
        if res.returncode != 0:
            print(f"kernel_ab: {tree} failed:\n{res.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            row = json.loads(line)
            row.update({"tree": tree, "turn": i})
            print(json.dumps(row), flush=True)
            key = f"{row['kernel']} {json.dumps(row['shape'])}"
            times.setdefault(key, {}).setdefault(tree, []).append(row["ms"])
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"mean_ms": {
        key: {tree: sum(ms) / len(ms) for tree, ms in by_tree.items()}
        for key, by_tree in times.items()}}), flush=True)
    return 0 if all(math.isfinite(t) for by_tree in times.values()
                    for ms in by_tree.values() for t in ms) else 1


if __name__ == "__main__":
    sys.exit(main())
