"""The port's checkpoints and train session (ray_tpu_torch.train
checkpoint.py, session.py, checkpointing.py) on the CPU:

- `CheckpointManager` top-k retention and the `Checkpoint` roundtrip
  (tests/test_train_lib.py's cases), on both packages with the same
  outcome;
- the train session: `report` hands metrics and checkpoints to the
  driver in lockstep, `get_checkpoint` gives the resume checkpoint,
  and outside a session both behave as the JAX package's do;
- a GPT-2-tiny `TrainState` (adamw, two steps taken) saved and loaded
  into a template of other values: its next step is bitwise equal to
  the unsaved state's next step; a bf16 tree and the saved structure
  without a template round-trip exactly;
- a checkpoint written by the JAX package's `save_train_state`
  (GPT-2-tiny, optax.adamw, two steps) loaded by the port by leaf order:
  equal to `interop.train_state_from_jax` of the same state, and its
  next step matches JAX's next step within LOSS_TOL on the loss and
  PARAM_TOL of each leaf's largest value on the params (the tolerances
  of tests/test_torch_gpt2_train.py);
- on two gloo ranks, a ZeRO-3 state saved, loaded into a ZeRO-0
  template, saved again and loaded back into a ZeRO-3 template: every
  value equal, each leaf in its template's placements, and the next
  steps of the first and last states bitwise equal.

jax is imported only inside functions: the rank processes import this
module and must not load it."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_collectives import run_ranks

LOSS_TOL = 1e-4
PARAM_TOL = 1e-3  # of each leaf's largest absolute value
B, T = 2, 32


def _tiny():
    from ray_tpu_torch.models import gpt2

    return dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.float32)


def _batch(seed, vocab):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _state(seed, tx, cfg):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import TrainState

    gen = torch.Generator().manual_seed(seed)
    return TrainState.create(gpt2.init_gpt2(gen, cfg, device="cpu"), tx)


def _step(tx, cfg):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import make_train_step

    return make_train_step(lambda p, b: gpt2.gpt2_loss(p, b, cfg), tx)


def _equal_trees(a, b) -> bool:
    from ray_tpu_torch.util import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------------------------ manager


def _manager_topk(train, root):
    mgr = train.CheckpointManager(
        str(root / "exp"),
        train.CheckpointConfig(num_to_keep=2,
                               checkpoint_score_attribute="acc"))
    for i, acc in enumerate([0.1, 0.9, 0.5, 0.3]):
        src = root / f"ck{i}"
        src.mkdir()
        (src / "model.txt").write_text(str(i))
        mgr.register(train.Checkpoint(str(src)), {"acc": acc})
    kept = sorted(os.listdir(root / "exp"))
    with open(os.path.join(mgr.best().path, "model.txt")) as f:
        best = f.read()
    latest = os.path.basename(mgr.latest().path)
    # a new manager on the same directory picks the index up again
    again = train.CheckpointManager(str(root / "exp"))
    return kept, best, latest, os.path.basename(again.latest().path)


def _roundtrip(train, root):
    src = root / "src"
    src.mkdir()
    (src / "w.npy").write_bytes(b"abc")
    ck = train.Checkpoint.from_directory(str(src))
    ck.to_directory(str(root / "dst"))
    with ck.as_directory() as d:
        inside = sorted(os.listdir(d))
    with pytest.raises(ValueError, match="not a directory"):
        train.Checkpoint.from_directory(str(root / "missing"))
    return (root / "dst" / "w.npy").read_bytes(), inside


@pytest.mark.parametrize("case", [_manager_topk, _roundtrip],
                         ids=["manager_topk", "roundtrip"])
def test_checkpoint_library_matches_jax(case, tmp_path):
    from ray_tpu.train import checkpoint as jax_ckpt

    from ray_tpu_torch.train import checkpoint as port_ckpt

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = case(jax_ckpt, tmp_path / "jax")
    got = case(port_ckpt, tmp_path / "port")
    assert got == want
    if case is _manager_topk:
        # top-2 by acc (0.9, 0.5) plus the most recent (0.3)
        assert got[0] == ["checkpoint_000001", "checkpoint_000002",
                          "checkpoint_000003"] and got[1] == "1"


# ------------------------------------------------------------ session


def _session_run(session_mod, ckpt_cls, root):
    ctx = session_mod.TrainContext(
        world_size=1, world_rank=0, local_rank=0, local_world_size=1,
        node_rank=0, experiment_name="exp", trial_dir=str(root),
        coordinator_address=None)
    outside = []
    for fn in (lambda: session_mod.report({"a": 1}),
               session_mod.get_context):
        try:
            fn()
        except RuntimeError:
            outside.append("raised")
    outside.append(session_mod.get_checkpoint())
    resume = ckpt_cls(str(root))
    s = session_mod.init_session(ctx, resume_checkpoint=resume)
    try:
        seen = {}

        def worker():
            c = session_mod.get_context()
            seen["rank"] = (c.get_world_rank(), c.get_world_size(),
                            c.get_trial_dir() == str(root))
            seen["resume"] = session_mod.get_checkpoint().path
            for i in range(3):
                session_mod.report(
                    {"i": i}, checkpoint=resume if i == 2 else None)

        th = threading.Thread(target=worker)
        th.start()
        results = []
        while len(results) < 3:
            r = s.next_result(timeout=5.0)
            assert r is not None, "the worker stopped reporting"
            results.append((r["metrics"], r["checkpoint_dir"]))
        th.join(timeout=10)
        assert not th.is_alive()
    finally:
        session_mod.shutdown_session()
    return outside, seen, results, session_mod.get_session()


def test_session_matches_jax(tmp_path):
    from ray_tpu.train import checkpoint as jax_ckpt
    from ray_tpu.train import session as jax_session

    from ray_tpu_torch.train import checkpoint as port_ckpt
    from ray_tpu_torch.train import session as port_session

    want = _session_run(jax_session, jax_ckpt.Checkpoint, tmp_path)
    got = _session_run(port_session, port_ckpt.Checkpoint, tmp_path)
    assert got == want
    outside, seen, results, after = got
    assert outside == ["raised", "raised", None]
    assert seen == {"rank": (0, 1, True), "resume": str(tmp_path)}
    assert results == [({"i": 0}, None), ({"i": 1}, None),
                       ({"i": 2}, str(tmp_path))]
    assert after is None


# ------------------------------------------------------------ train state


def test_train_state_roundtrip_next_step_is_bitwise_equal(tmp_path):
    from ray_tpu_torch.train import adamw
    from ray_tpu_torch.train.checkpointing import (
        load_train_state,
        save_train_state,
    )

    cfg = _tiny()
    tx = adamw(1e-3, weight_decay=0.1)
    step = _step(tx, cfg)
    state = _state(0, tx, cfg)
    batch = _batch(1, cfg.vocab_size)
    for _ in range(2):
        state, _ = step(state, batch)
    save_train_state(state, str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck")) == ["state.npz",
                                                   "treedef.pkl"]
    loaded = load_train_state(str(tmp_path / "ck"), _state(7, tx, cfg))
    assert loaded.step == 2 and loaded.opt_state.count == 2
    assert isinstance(loaded.step, int)
    assert _equal_trees(loaded.params, state.params)
    assert _equal_trees(loaded.opt_state.mu, state.opt_state.mu)
    a, ma = step(state, batch)
    b, mb = step(loaded, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])
    assert _equal_trees(a.params, b.params)
    assert _equal_trees(a.opt_state.nu, b.opt_state.nu)


def test_structure_and_bf16_roundtrip_without_template(tmp_path):
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.checkpointing import load_pytree, save_pytree

    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    tree_ = {"b": [w.to(torch.bfloat16), (torch.arange(4), 2.5)],
             "a": optim.ScaleByAdamState(count=3, mu={"w": w}, nu=None),
             "c": (optim.EmptyState(), None, True)}
    save_pytree(tree_, str(tmp_path))
    with np.load(tmp_path / "state.npz") as data:
        # JAX order: a (count, mu/w), then b, c's bool
        assert sorted(data.files) == [f"leaf_{i}" for i in range(6)]
        assert int(data["leaf_0"]) == 3
    got = load_pytree(str(tmp_path), device="cpu")
    assert isinstance(got["a"], optim.ScaleByAdamState)
    assert torch.equal(got["a"].mu["w"], w)
    assert got["a"].count == 3 and got["a"].nu is None
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], tree_["b"][0])
    assert torch.equal(got["b"][1][0], torch.arange(4))
    assert got["b"][1][1] == 2.5 and isinstance(got["b"][1], tuple)
    assert isinstance(got["c"][0], optim.EmptyState)
    assert got["c"][1:] == (None, True)
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path), {"x": w})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_pytree(str(tmp_path))  # the card by default: no fallback


def test_jax_checkpoint_loads_by_leaf_order(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt2 as jax_gpt2
    from ray_tpu.train import checkpointing as jax_ckpt
    from ray_tpu.train import spmd as jax_spmd

    from ray_tpu_torch import interop
    from ray_tpu_torch.train import adamw
    from ray_tpu_torch.train.checkpointing import (
        _read_meta,
        load_pytree,
        load_train_state,
    )
    from ray_tpu_torch.util import tree

    cfg = _tiny()
    jcfg = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dtype=jnp.float32)
    jtx = optax.adamw(1e-3, weight_decay=0.1)
    jstep = jax_spmd.make_train_step(
        lambda p, b: jax_gpt2.gpt2_loss(p, b, jcfg), jtx, donate=False)
    jstate = jax_spmd.TrainState.create(
        jax_gpt2.init_gpt2(jax.random.PRNGKey(0), jcfg), jtx)
    batch = _batch(5, cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, _ = jstep(jstate, jbatch)
    jax_ckpt.save_train_state(jstate, str(tmp_path))
    assert _read_meta(str(tmp_path)) is None  # a jax treedef: not read
    with pytest.raises(ValueError, match="JAX package"):
        load_pytree(str(tmp_path), device="cpu")

    tx = adamw(1e-3, weight_decay=0.1)
    loaded = load_train_state(str(tmp_path), _state(9, tx, cfg))
    assert loaded.step == 2 and loaded.opt_state.count == 2
    want = interop.train_state_from_jax(jstate)
    assert want.step == 2 and want.opt_state.count == 2
    assert _equal_trees(loaded.params, want.params)
    assert _equal_trees(loaded.opt_state.mu, want.opt_state.mu)
    assert _equal_trees(loaded.opt_state.nu, want.opt_state.nu)

    jstate, jm = jstep(jstate, jbatch)
    state, m = _step(tx, cfg)(loaded, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    jleaves = jax.tree_util.tree_leaves(jstate.params)
    for (path, t), j in zip(tree.leaves_with_path(state.params), jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.numpy(), j, rtol=0, atol=PARAM_TOL * np.abs(j).max(),
            err_msg="/".join(path))


# ------------------------------------------------------------ ZeRO


def _zero_roundtrip_body(rank, root):
    """On each of two gloo ranks: a ZeRO-3 GPT-2-tiny state after one
    adamw step, saved, loaded into ZeRO-0, saved, loaded into ZeRO-3."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import (
        adamw,
        init_sharded_state,
        make_train_step,
    )
    from ray_tpu_torch.train.checkpointing import (
        load_train_state,
        save_train_state,
    )
    from ray_tpu_torch.util import tree

    cfg = _tiny()
    mesh = build_mesh(MeshSpec(data=2), device="cpu")
    rules = gpt2.gpt2_partition_rules()
    tx = adamw(1e-3, weight_decay=0.1)

    def fresh(seed, stage):
        gen = torch.Generator().manual_seed(seed)
        return init_sharded_state(
            lambda: gpt2.init_gpt2(gen, cfg, device="cpu"), tx, mesh,
            rules, zero_stage=stage)

    def step(stage):
        return make_train_step(lambda p, b: gpt2.gpt2_loss(p, b, cfg), tx,
                               mesh=mesh, rules=rules, zero_stage=stage)

    batch = _batch(11, cfg.vocab_size)
    step3 = step(3)
    z3, _ = step3(fresh(0, 3), batch)
    save_train_state(z3, os.path.join(root, "z3"))
    tmpl0 = fresh(1, 0)
    z0 = load_train_state(os.path.join(root, "z3"), tmpl0)
    save_train_state(z0, os.path.join(root, "z0"))
    tmpl3 = fresh(2, 3)
    back = load_train_state(os.path.join(root, "z0"), tmpl3)

    def full(state):
        return [t.full_tensor() for t in
                tree.leaves(state.params) + tree.leaves(state.opt_state.mu)
                + tree.leaves(state.opt_state.nu)]

    def placements(state):
        return [tuple(t.placements) for t in
                tree.leaves(state.params) + tree.leaves(state.opt_state.mu)]

    a, b, c = full(z3), full(z0), full(back)
    out = {
        "z0_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
        "back_equal": all(torch.equal(x, y) for x, y in zip(a, c)),
        "dtensors": all(isinstance(t, DTensor) for t in
                        tree.leaves(back.params) + tree.leaves(z0.params)),
        "z0_placements": placements(z0) == placements(tmpl0),
        "back_placements": placements(back) == placements(tmpl3),
        "sharded_differs": placements(tmpl0) != placements(tmpl3),
        "steps": (z3.step, z0.step, back.step, back.opt_state.count),
    }
    _, m1 = step3(z3, batch)
    _, m2 = step3(back, batch)
    out["next_loss_equal"] = float(m1["loss"]) == float(m2["loss"])
    return out


def test_zero3_state_roundtrips_through_zero0_on_two_ranks(tmp_path):
    root = tmp_path / "ckpt"
    root.mkdir()
    ranks = run_ranks(_zero_roundtrip_body, tmp_path, str(root), world=2)
    for out in ranks:
        assert out == {"z0_equal": True, "back_equal": True,
                       "dtensors": True, "z0_placements": True,
                       "back_placements": True, "sharded_differs": True,
                       "steps": (1, 1, 1, 1), "next_loss_equal": True}
