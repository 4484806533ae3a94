"""After which phase of chip_smoke.py torch.profiler loses the card.

Takes GPT-2-small train steps (train's recipe, seed 0) inside
``ray_tpu_torch.util.tracing.profiler_capture`` once before the named
phases and once after each of them, the phases run in the order given
(by default chip_smoke's RL phases, in the script's order). For each
capture it prints one JSON line: K1-K3's launches, their kernel events
in the chrome trace (``tracing.kernel_events``), all its device events,
and the capture's error where it raised (a trace that lost records of
the port's kernels). Run from the root of a checkout, on a card:

    python3 chip_profiler.py [phase ...]

A phase is a chip_smoke phase function's name without ``phase_``
(``rl``, ``ppo_cartpole``, ..., ``ope``); ``rl_update`` runs only phase
8's profiled GRPO update. Traces go to ``build/profiler_check/``.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "profiler_check")
STEPS = 2
RL_PHASES = ("rl", "ppo_cartpole", "ppo_pixel", "ppo_learner_atari",
             "dqn_cartpole", "ppo_learners", "f3_determinism",
             "impala_cartpole", "appo_cartpole", "sac_pendulum", "dreamer",
             "multi_agent", "ope")


def capture(cs, n: int, label: str, train: list) -> dict:
    """STEPS train steps of `train` (step, state, batch) inside
    ``profiler_capture``; the launches against the trace's events."""
    from ray_tpu_torch.util import tracing

    step, state, batch = train
    out = os.path.join(OUT, f"{n}-{label}")
    shutil.rmtree(out, ignore_errors=True)
    counters = cs._reset_counters()
    row = {"after": label, "raised": None}
    t0 = time.perf_counter()
    try:
        with tracing.profiler_capture(out, device="cuda"):
            for _ in range(STEPS):
                state, _ = step(state, batch)
    except RuntimeError as e:
        row["raised"] = str(e)
    row["capture_s"] = time.perf_counter() - t0
    train[1] = state
    (path,) = [os.path.join(out, f) for f in os.listdir(out)]
    launches = cs.launch_counts(counters)
    row["launches"] = {k: launches[k] for k in cs.OBSERVE_KERNELS}
    row["kernel_events"] = {k: n for k, n in tracing.kernel_events(
        path).items() if k in cs.OBSERVE_KERNELS}
    row["device_events"] = tracing.device_events(path)
    cs.emit({"profiler_check": row})
    return row


def run_phase(torch, cs, card: str, name: str) -> None:
    if name == "rl_update":
        learner, engine, fly, _ = cs._rl_setup(torch, "gpt2")
        _, trajs = cs._rl_laps(torch, "rl", learner, engine, fly, 1)
        cs.emit(cs._rl_profiled_update(torch, learner, trajs[-1]))
    elif name == "ppo_learners":
        cs.phase_ppo_learners()
    else:
        getattr(cs, f"phase_{name}")(torch, card)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.use_bytecode_cache(ROOT)
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a "
                "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    card = cs.phase_device(torch)
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_gpt2

    cfg = GPT2Config.small()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state, step, batch = cs._gpt2_train_setup(torch, init_gpt2(gen, cfg),
                                              cfg, gen)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    train = [step, state, batch]
    rows = [capture(cs, 0, "start", train)]
    for n, name in enumerate(argv or RL_PHASES, 1):
        t0 = time.perf_counter()
        try:
            run_phase(torch, cs, card, name)
            status = "passed"
        except SystemExit:
            status = "failed"
        cs.release(torch)
        cs.emit({"phase_ran": name, "status": status,
                 "seconds": time.perf_counter() - t0})
        rows.append(capture(cs, n, name, train))
    lost = [r["after"] for r in rows if r["raised"]]
    cs.emit({"profiler_check_summary": {
        "captures": len(rows), "lost_records_after": lost}, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
