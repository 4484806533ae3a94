"""The port's durable workflows (ray_tpu_torch/workflow.py) through the
scenarios of tests/test_workflow.py (9) on one module-scoped cluster
runtime of the port (`init(num_cpus=4)`, the JAX fixture's), then the
same DAGs' outputs and resume behaviour held against the JAX package's
(its workflows on its local runtime), and a resume in a new driver
process that skips the step a crashed driver finished: the port's step
ids are the same in every process. Step functions are defined inside
the tests, so they travel by value, with `_touch_count`, which a factory
makes for that reason."""

import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import workflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()


def _counter():
    def touch_count(path):
        n = int(open(path).read()) if os.path.exists(path) else 0
        with open(path, "w") as f:
            f.write(str(n + 1))
        return n + 1

    return touch_count


# made in a factory, so it travels by value with the steps that call it
_touch_count = _counter()


def test_linear_dag_runs_and_persists(cluster, tmp_path):
    @workflow.step
    def load():
        return [1, 2, 3, 4]

    @workflow.step
    def double(xs):
        return [2 * x for x in xs]

    @workflow.step
    def total(xs):
        return sum(xs)

    dag = total.step(double.step(load.step()))
    out = workflow.run(dag, workflow_id="lin", storage=str(tmp_path))
    assert out == 20
    assert workflow.get_status("lin", storage=str(tmp_path)) == \
        workflow.SUCCESS
    assert workflow.get_output("lin", storage=str(tmp_path)) == 20
    assert ("lin", workflow.SUCCESS) in workflow.list_all(
        storage=str(tmp_path))


def test_diamond_shared_step_executes_once(cluster, tmp_path):
    marker = str(tmp_path / "source_runs")

    @workflow.step
    def source():
        _touch_count(marker)
        return 10

    @workflow.step
    def left(x):
        return x + 1

    @workflow.step
    def right(x):
        return x + 2

    @workflow.step
    def join(a, b):
        return a * b

    src = source.step()
    out = workflow.run(join.step(left.step(src), right.step(src)),
                       workflow_id="diamond", storage=str(tmp_path))
    assert out == 11 * 12
    assert int(open(marker).read()) == 1, "shared step ran twice"


def test_failure_then_resume_skips_finished_steps(cluster, tmp_path):
    """The durability contract: after a mid-DAG failure, resume()
    re-executes ONLY the unfinished suffix (reference:
    test_workflow resume semantics)."""
    a_runs = str(tmp_path / "a_runs")
    fixed = str(tmp_path / "fixed")

    @workflow.step
    def stage_a():
        _touch_count(a_runs)
        return 5

    @workflow.step(max_retries=0)
    def flaky(x):
        if not os.path.exists(fixed):
            raise RuntimeError("transient outage")
        return x * 100

    dag = flaky.step(stage_a.step())
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="crash", storage=str(tmp_path))
    assert workflow.get_status("crash", storage=str(tmp_path)) == \
        workflow.RESUMABLE
    assert int(open(a_runs).read()) == 1

    open(fixed, "w").close()  # outage over
    out = workflow.resume("crash", storage=str(tmp_path))
    assert out == 500
    assert int(open(a_runs).read()) == 1, "finished step re-executed"
    assert workflow.get_status("crash", storage=str(tmp_path)) == \
        workflow.SUCCESS


def test_resume_of_finished_workflow_returns_output(cluster, tmp_path):
    @workflow.step
    def one():
        return 1

    workflow.run(one.step(), workflow_id="done", storage=str(tmp_path))
    assert workflow.resume("done", storage=str(tmp_path)) == 1


def test_step_ids_deterministic_and_input_sensitive(cluster):
    @workflow.step
    def f(x):
        return x

    assert f.step(1).step_id() == f.step(1).step_id()
    assert f.step(1).step_id() != f.step(2).step_id()


def test_kwargs_and_options(cluster, tmp_path):
    @workflow.step
    def scale(x, *, factor=1):
        return x * factor

    out = workflow.run(scale.options(name="scaled").step(3, factor=7),
                       workflow_id="kw", storage=str(tmp_path))
    assert out == 21


def test_fan_in_steps_nested_in_containers(cluster, tmp_path):
    """StepNodes nested inside list/dict args resolve to their results
    and hash structurally (stable ids across resumes)."""

    @workflow.step
    def const(x):
        return x

    @workflow.step
    def total(parts, named):
        return sum(parts) + named["extra"]

    dag = total.step([const.step(1), const.step(2), const.step(3)],
                     {"extra": const.step(10)})
    assert workflow.run(dag, workflow_id="fanin",
                        storage=str(tmp_path)) == 16
    # resume of the finished workflow is a pure storage read
    assert workflow.resume("fanin", storage=str(tmp_path)) == 16

    dag2 = total.step([const.step(1), const.step(2), const.step(3)],
                      {"extra": const.step(10)})
    assert dag.step_id() == dag2.step_id()


def test_step_identity_includes_function_body(cluster, tmp_path):
    """Two same-named steps with different bodies must not share
    persisted results (fn code is part of the step id)."""

    def make(ret):
        @workflow.step(name="load")
        def load():
            return ret

        return load

    a, b = make("A"), make("B")
    assert a.step().step_id() != b.step().step_id()
    assert workflow.run(a.step(), workflow_id="ida",
                        storage=str(tmp_path)) == "A"
    assert workflow.run(b.step(), workflow_id="ida",
                        storage=str(tmp_path)) == "B"  # no stale reuse


def test_step_timeout_option(cluster, tmp_path):
    import time as _t

    @workflow.step(timeout_s=1.0, max_retries=0)
    def slow():
        _t.sleep(30)
        return 1

    with pytest.raises(Exception):
        workflow.run(slow.step(), workflow_id="slowwf",
                     storage=str(tmp_path))
    assert workflow.get_status("slowwf", storage=str(tmp_path)) == \
        workflow.RESUMABLE


# ---------------------------------------------------------------------------
# outputs and resume behaviour against the JAX package's
# ---------------------------------------------------------------------------

def _dags(wf):
    """The scenarios' DAGs, built with one package's workflow module."""
    @wf.step
    def load():
        return [1, 2, 3, 4]

    @wf.step
    def double(xs):
        return [2 * x for x in xs]

    @wf.step
    def total(xs):
        return sum(xs)

    @wf.step
    def const(x):
        return x

    @wf.step
    def join(parts, named):
        return sum(parts) + named["extra"]

    @wf.step
    def scale(x, *, factor=1):
        return x * factor

    src = const.step(10)
    return {
        "linear": total.step(double.step(load.step())),
        "diamond": join.step([scale.step(src, factor=2), const.step(src)],
                             {"extra": src}),
        "fanin": join.step([const.step(1), const.step(2), const.step(3)],
                           {"extra": const.step(10)}),
        "kwargs": scale.options(name="scaled").step(3, factor=7),
    }


@pytest.fixture(scope="module")
def jax_local():
    import ray_tpu as jax_ray

    jax_ray.init(local_mode=True, num_cpus=4)
    yield jax_ray
    jax_ray.shutdown()


@pytest.mark.parametrize("name", ["linear", "diamond", "fanin", "kwargs"])
def test_outputs_match_jax(cluster, jax_local, tmp_path, name):
    from ray_tpu import workflow as jax_wf

    outs = [wf.run(_dags(wf)[name], workflow_id=name,
                   storage=str(tmp_path / tag))
            for wf, tag in ((workflow, "port"), (jax_wf, "jax"))]
    assert outs[0] == outs[1]
    assert [wf.list_all(storage=str(tmp_path / tag))
            for wf, tag in ((workflow, "port"), (jax_wf, "jax"))] == \
        [[(name, "SUCCESS")]] * 2


def test_resume_behaviour_matches_jax(cluster, jax_local, tmp_path):
    """A DAG whose second step fails until a marker exists: both
    packages raise, report RESUMABLE, run the first step once across
    the run and the resume, and resume to the same value."""
    from ray_tpu import workflow as jax_wf

    def scenario(wf, d):
        runs, fixed = str(d / "runs"), str(d / "fixed")

        @wf.step
        def first():
            n = int(open(runs).read()) if os.path.exists(runs) else 0
            with open(runs, "w") as f:
                f.write(str(n + 1))
            return 7

        @wf.step(max_retries=0)
        def second(x):
            if not os.path.exists(fixed):
                raise RuntimeError("not yet")
            return x * 6

        seen = []
        try:
            wf.run(second.step(first.step()), workflow_id="r",
                   storage=str(d))
        except Exception:  # noqa: BLE001
            seen.append("raised")
        seen.append(wf.get_status("r", storage=str(d)))
        open(fixed, "w").close()
        seen.append(wf.resume("r", storage=str(d)))
        seen.append(wf.get_status("r", storage=str(d)))
        seen.append(int(open(runs).read()))
        seen.append(wf.get_output("r", storage=str(d)))
        return seen

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = scenario(workflow, tmp_path / "port")
    assert port == scenario(jax_wf, tmp_path / "jax")
    assert port == ["raised", workflow.RESUMABLE, 42, workflow.SUCCESS, 1, 42]


_CRASHING_DRIVER = """
import os, signal, sys, time
import ray_tpu_torch as ray
from ray_tpu_torch import workflow

store, marker = sys.argv[1], sys.argv[2]

@workflow.step
def expensive(xs):
    with open(os.path.join(store, "expensive_runs"), "a") as f:
        f.write("x")
    return list(map(lambda x: x * x, xs))  # nested code in the step

@workflow.step(max_retries=0)
def finish(ys, scale):
    if not os.path.exists(marker):
        # the driver crashes: this worker's parent is the nodelet that
        # init() booted in the driver's process
        os.kill(os.getppid(), signal.SIGKILL)
        time.sleep(60)
    return scale(sum(ys))

ray.init(num_cpus=2)
workflow.run(finish.step(expensive.step([1, 2, 3]), scale=lambda v: v),
             workflow_id="xp", storage=store)
"""


def test_resume_in_a_new_process_skips_finished_steps(cluster, tmp_path):
    """A driver is killed while its last step runs; another process
    resumes the workflow from storage: the DAG is unpickled
    there, every step id is recomputed (a lambda among the inputs, a
    nested lambda in a step's code, whose repr holds its address) and
    the finished step is not run again."""
    store, marker = str(tmp_path / "store"), str(tmp_path / "marker")
    os.makedirs(store)
    script = tmp_path / "driver.py"
    script.write_text(textwrap.dedent(_CRASHING_DRIVER))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, str(script), store, marker],
                       env=env, timeout=120, check=False)
    assert r.returncode == -9
    assert workflow.get_status("xp", storage=store) == workflow.RESUMABLE
    assert open(os.path.join(store, "expensive_runs")).read() == "x"
    open(marker, "w").close()
    resume = ("import sys\n"
              "import ray_tpu_torch as ray\n"
              "from ray_tpu_torch import workflow\n"
              "ray.init(num_cpus=2)\n"
              "print('value', workflow.resume('xp', storage=sys.argv[1]))\n")
    r = subprocess.run([sys.executable, "-c", resume, store], env=env,
                       capture_output=True, text=True, timeout=120)
    assert "value 14" in r.stdout, r.stderr
    assert open(os.path.join(store, "expensive_runs")).read() == "x"
    assert workflow.get_status("xp", storage=store) == workflow.SUCCESS
