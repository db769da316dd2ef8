"""The DiT Trainer's hooks in the port against the JAX package, on the CPU.

* MetricsWriter against the JAX one on the same records: metrics.jsonl
  byte-equal, the TensorBoard scalars read back through tensorboard's
  event_accumulator equal; wandb asked for but absent is a no-op.
* The Trainer writes its log records through the writer (JSONL and
  <save_dir>/runs/train), on the writer rank only.
* fit's hooks against the JAX Trainer on a deterministic toy loss:
  evaluation every eval_interval, the clean exit at exit_interval with its
  final save, skip_nan on and off over a non-finite batch; the log records,
  evaluation losses, skip counts and parameters (1e-6).
* Evaluation draws from its own generator: the training losses with
  eval_interval=1 are bit-equal to those without evaluation.
* check_param_sync and sync_params_across_ranks in a gloo world of 2 (data 2
  and model 2): 0.0 on agreeing copies, a drift injected on rank 1 detected
  (and raised above atol), then synced back to 0.0.
* Timers (the JAX log line), report_memory (None without CUDA, as JAX's CPU
  device reports no stats), profile_trace / annotate, print_rank0.

The spawned ranks import this file: no jax at its top.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scail_tpu_torch.training.engine import TrainConfig, Trainer  # noqa: E402
from scail_tpu_torch.utils.metrics_writers import MetricsWriter  # noqa: E402

RECORDS = [{"iter": 1, "loss": 0.5, "lr": 1e-4, "grad_norm": 2.25, "skipped": 0},
           {"iter": 2, "loss": 0.25, "lr": 2e-4, "grad_norm": 1.5, "skipped": 1,
            "note": "text is kept in the JSONL only"},
           {"step": 7, "eval_loss": 0.125, "flag": True}]


def _scalars(logdir):
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here: the ranks import this file)."""
    import jax
    import jax.numpy as jnp

    import scail_tpu.training.engine as jengine
    import scail_tpu.utils.metrics_writers as jwriters
    import scail_tpu.utils.timers as jtimers

    return dict(jax=jax, jnp=jnp, engine=jengine, writers=jwriters, timers=jtimers)


def test_metrics_writer_matches_jax(J, tmp_path):
    dirs = {}
    for side, cls in (("jax", J["writers"].MetricsWriter), ("port", MetricsWriter)):
        d = str(tmp_path / side)
        w = cls(d, enable_tensorboard=True, enable_wandb=True, run_name=None)
        for r in RECORDS:
            w.write(dict(r))
        w.close()
        dirs[side] = d
    assert MetricsWriter(str(tmp_path / "x"), enable_wandb=True).backends == \
        {"jsonl": True, "tensorboard": True, "wandb": False}  # wandb absent: a no-op
    want = open(os.path.join(dirs["jax"], "metrics.jsonl"), "rb").read()
    assert open(os.path.join(dirs["port"], "metrics.jsonl"), "rb").read() == want
    got_tb = _scalars(os.path.join(dirs["port"], "runs", "train"))
    assert got_tb == _scalars(os.path.join(dirs["jax"], "runs", "train"))
    assert got_tb["loss"] == [(1, 0.5), (2, 0.25)] and got_tb["eval_loss"] == [(7, 0.125)]
    assert "note" not in got_tb and got_tb["flag"] == [(7, 1.0)]
    assert MetricsWriter(None).backends == {"jsonl": False, "tensorboard": False,
                                            "wandb": False}


# --------------------------------------------------------------------------
# the toy trainer on both sides
# --------------------------------------------------------------------------
class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)
        with torch.no_grad():
            self.lin.weight.copy_(torch.from_numpy(w.T.copy()))
            self.lin.bias.copy_(torch.from_numpy(b.copy()))


def _toy_data(n, nan_at=None, seed=0):
    rng = np.random.default_rng(seed)
    out = [{"x": rng.standard_normal((2, 4)).astype(np.float32),
            "y": rng.standard_normal((2, 3)).astype(np.float32)} for _ in range(n)]
    if nan_at is not None:
        out[nan_at]["y"][0, 0] = np.nan
    return out


def _toy_params(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 3)).astype(np.float32) * 0.5,
            rng.standard_normal(3).astype(np.float32) * 0.1)


def _port_toy(cfg_kw, noise=False):
    w, b = _toy_params()
    model = _Toy(w, b)

    def loss_fn(gen, batch):
        err = model.lin(batch["x"]) - batch["y"]
        if noise:
            err = err - 0.1 * torch.randn(err.shape, generator=gen)
        return err.square().mean()

    return Trainer(model, loss_fn, TrainConfig(**cfg_kw)), model, loss_fn


def _recorded(trainer_cls, monkeypatch):
    """Record every log record and evaluation loss of trainer_cls."""
    seen = {"records": [], "evals": []}
    real_eval = trainer_cls.evaluate

    def log(self, record):
        seen["records"].append(dict(record))

    def evaluate(self, *a, **kw):
        seen["evals"].append(real_eval(self, *a, **kw))
        return seen["evals"][-1]

    monkeypatch.setattr(trainer_cls, "_log_metrics", log)
    monkeypatch.setattr(trainer_cls, "evaluate", evaluate)
    return seen


HOOK_CASES = {
    "eval_and_exit": (dict(train_iters=6, eval_interval=2, eval_iters=2, exit_interval=3), None),
    "skip_nan_on": (dict(train_iters=4), 1),
    "skip_nan_off": (dict(train_iters=4, skip_nan=False), 1),
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_fit_hooks_match_the_jax_trainer(J, case, monkeypatch, tmp_path):
    jnp = J["jnp"]
    kw, nan_at = HOOK_CASES[case]
    kw = dict(kw, lr=1e-2, warmup_iters=1, log_interval=1)
    data, evals = _toy_data(6, nan_at), _toy_data(6, seed=3)

    # JAX: the same loss on params {w, b}; evaluation on its own batches
    def jloss(p, key, batch):
        return jnp.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    w, b = _toy_params()
    jseen = _recorded(J["engine"].Trainer, monkeypatch)
    jt = J["engine"].Trainer({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jloss,
                             J["engine"].TrainConfig(**kw, save_dir=str(tmp_path / "jax")))
    jt.fit(iter([{k: jnp.asarray(v) for k, v in d.items()} for d in data]),
           iter([{k: jnp.asarray(v) for k, v in d.items()} for d in evals]), jloss)

    pseen = _recorded(Trainer, monkeypatch)
    pt, model, loss_fn = _port_toy(dict(kw, save_dir=str(tmp_path / "port")))
    history = pt.fit(iter([{k: torch.from_numpy(v) for k, v in d.items()} for d in data]),
                     iter([{k: torch.from_numpy(v) for k, v in d.items()} for d in evals]),
                     loss_fn)
    pt.wait_for_save()

    steps = int(jt.state["step"])
    assert pt.step == steps == len(history) and pt.skipped == int(jt.state["skipped"])
    if case == "eval_and_exit":
        assert steps == 3 and len(pseen["evals"]) == 1 == len(jseen["evals"])
        from scail_tpu_torch.training.checkpoint import read_latest

        assert read_latest(str(tmp_path / "port")) == "3"  # the final save after the exit
    assert pt.skipped == (1 if case == "skip_nan_on" else 0)
    np.testing.assert_allclose(pseen["evals"], jseen["evals"], rtol=1e-6)
    assert len(pseen["records"]) == len(jseen["records"]) == steps
    for got, want in zip(pseen["records"], jseen["records"]):
        assert list(got) == list(want)
        for k in ("iter", "skipped"):
            assert got[k] == want[k]
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    p = jt.state["params"]
    np.testing.assert_allclose(model.lin.weight.detach().numpy(), np.asarray(p["w"]).T,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(model.lin.bias.detach().numpy(), np.asarray(p["b"]),
                               rtol=1e-6, atol=1e-7)
    if case == "skip_nan_off":  # the update was applied: every parameter is NaN
        assert torch.isnan(model.lin.weight).all() and pt.opt_state.count == 4


def test_trainer_writes_its_records_through_the_metrics_writer(tmp_path):
    trainer, _, _ = _port_toy(dict(train_iters=3, lr=1e-2, warmup_iters=1, log_interval=1,
                                   save_dir=str(tmp_path), experiment_name="toy"))
    trainer.fit(iter([{k: torch.from_numpy(v) for k, v in d.items()} for d in _toy_data(3)]))
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in lines] == [1, 2, 3]
    tb = _scalars(str(tmp_path / "runs" / "toy"))
    assert [s for s, _ in tb["loss"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in tb["loss"]], [r["loss"] for r in lines],
                               rtol=1e-6)
    off, _, _ = _port_toy(dict(train_iters=1, save_dir=str(tmp_path / "off"),
                               tensorboard=False))
    assert off.metrics_writer.backends == {"jsonl": True, "tensorboard": False, "wandb": False}


def test_evaluation_does_not_move_the_training_stream():
    kw = dict(train_iters=4, lr=1e-2, warmup_iters=1, log_interval=1)
    runs = []
    for ev in (None, 1):
        trainer, model, loss_fn = _port_toy(dict(kw, eval_interval=ev or 500, eval_iters=2),
                                            noise=True)
        data = iter([{k: torch.from_numpy(v) for k, v in d.items()} for d in _toy_data(4)])
        evals = iter([{k: torch.from_numpy(v) for k, v in d.items()}
                      for d in _toy_data(8, seed=5)])
        hist = trainer.fit(data, evals if ev else None, loss_fn if ev else None)
        runs.append(([m["loss"] for m in hist], trainer.generator.get_state(),
                     model.lin.weight.detach().clone()))
    assert runs[0][0] == runs[1][0]  # bit-equal losses
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    a, _, fn = _port_toy(dict(kw, eval_iters=2), noise=True)
    batch = {k: torch.from_numpy(v) for k, v in _toy_data(1)[0].items()}
    one, two = a.evaluate(iter([batch] * 2), fn), a.evaluate(iter([batch] * 2), fn)
    assert one == two  # evaluation draws the same noise at the same step


# --------------------------------------------------------------------------
# replica sync in a gloo world of 2
# --------------------------------------------------------------------------
def _w_sync(inputs):
    """A spawned rank: check and sync under data 2 and model 2."""
    import torch.distributed as dist

    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.sharding import PathRules, Rule
    from scail_tpu_torch.training.sync import check_param_sync, sync_params_across_ranks

    rank = dist.get_rank()
    rules = PathRules([Rule(r"^col\.weight$", ("model", None))])
    out = {}
    for name, spec in (("data2", MeshSpec(data=2)), ("model2", MeshSpec(model=2))):
        mesh = make_mesh(spec)
        g = torch.Generator().manual_seed(0)
        params = {"col.weight": torch.randn(4, 3, generator=g), "bias": torch.randn(5, generator=g)}
        if name == "model2":  # a column-parallel slice: each rank holds its own rows
            params["col.weight"] = params["col.weight"] + rank
        r = {"agree": check_param_sync(params, mesh=mesh, rules=rules)}
        if rank == 1:
            params["bias"][2] += 0.25
        r["drift"] = check_param_sync(params, atol=float("inf"), mesh=mesh, rules=rules)
        try:
            check_param_sync(params, mesh=mesh, rules=rules)
            r["raised"] = False
        except AssertionError:
            r["raised"] = True
        sync_params_across_ranks(params, mesh=mesh, rules=rules)
        r["after"] = check_param_sync(params, mesh=mesh, rules=rules)
        r["params"] = params
        out[name] = r
    return out


def test_check_param_sync_and_sync_params_in_a_gloo_world_of_2():
    from test_torch_parallel import collect_world, spawn_world

    with tempfile.TemporaryDirectory() as d:
        torch.save({}, os.path.join(d, "inputs.pt"))
        ranks = collect_world(spawn_world("test_torch_trainer_hooks", "_w_sync", 2, d), d)
    for name in ("data2", "model2"):
        r0, r1 = ranks[0][name], ranks[1][name]
        for r in (r0, r1):
            assert r["agree"] == 0.0 and r["after"] == 0.0 and r["raised"]
            assert r["drift"] == pytest.approx(0.25, abs=1e-6)
        assert torch.equal(r0["params"]["bias"], r1["params"]["bias"])
        sharded_equal = torch.equal(r0["params"]["col.weight"], r1["params"]["col.weight"])
        assert sharded_equal == (name == "data2")  # model slices are left as they are
    # one process: one copy
    from scail_tpu_torch.training.sync import check_param_sync, check_value_sync

    assert check_param_sync({"a": torch.ones(3)}) == 0.0 == check_value_sync(torch.ones(2))


# --------------------------------------------------------------------------
# timers, memory, traces, logging
# --------------------------------------------------------------------------
def test_timers_log_like_jax_and_report_memory_on_the_cpu(J, monkeypatch):
    from scail_tpu.utils.profiling import report_memory as jax_report_memory
    from scail_tpu_torch.utils import timers as T
    from scail_tpu_torch.utils.profiling import report_memory

    clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.0, 3.0, 3.5])
    monkeypatch.setattr(T.time, "perf_counter", lambda: next(clock))
    got = T.Timers()
    for name in ("data loader", "train_step"):
        got(name).start()
        got(name).stop()
    clock_j = iter([0.0, 0.5, 1.0, 1.25])
    monkeypatch.setattr(J["timers"].time, "perf_counter", lambda: next(clock_j))
    want = J["timers"].Timers()
    for name in ("data loader", "train_step"):
        want(name).start()
        want(name).stop()
    line = got.log(normalizer=0.5)
    assert line == want.log(normalizer=0.5) == "data loader: 1000.00ms | train_step: 500.00ms"
    assert got("data loader").elapsed() == 0.0  # log reset it
    T.device_sync()
    T.device_sync("cpu")
    assert report_memory("cpu") is None and jax_report_memory("cpu") is None
    with pytest.raises(AssertionError, match="not started"):
        T.Timers()("x").stop()


def test_profile_trace_holds_the_annotated_range(tmp_path):
    from scail_tpu_torch.utils.profiling import annotate, profile_trace, trace_path

    with profile_trace(str(tmp_path)):
        with annotate("toy_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(trace_path(str(tmp_path))))
    assert any(e.get("name") == "toy_step" for e in trace["traceEvents"])
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()


def test_print_rank0_logs_on_the_main_process(caplog):
    from scail_tpu_torch.utils import logging as L

    assert L.is_main_process()
    L.get_logger().propagate = True
    with caplog.at_level("INFO", logger="scail_tpu_torch"):
        L.print_rank0("hello")
        L.print_all("everyone")
    assert [r.getMessage() for r in caplog.records] == ["hello", "everyone"]


def test_the_lazily_imported_backends_pull_in_no_jax(tmp_path):
    """In a fresh interpreter: the Trainer with TensorBoard on writes its
    records, profile_trace writes a trace, and neither jax nor any module
    of the JAX package gets imported.  TensorBoard would import TensorFlow
    where one is installed, and TensorFlow imports ml_dtypes and jax.version:
    the writer keeps TensorBoard on its stub, so TensorFlow stays out too."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import torch\n"
        "from scail_tpu_torch.training.engine import TrainConfig, Trainer\n"
        "from scail_tpu_torch.utils.profiling import profile_trace, annotate\n"
        "m = torch.nn.Linear(4, 3)\n"
        "t = Trainer(m, lambda g, b: m(b).square().mean(), TrainConfig(train_iters=2, "
        f"log_interval=1, warmup_iters=1, save_dir={str(tmp_path)!r}, wandb=True))\n"
        f"with profile_trace({str(tmp_path / 'trace')!r}), annotate('x'):\n"
        "    t.fit(iter([torch.ones(2, 4)] * 2))\n"
        "assert t.metrics_writer.backends['tensorboard'], t.metrics_writer.backends\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or "
        "m == 'scail_tpu' or m.startswith('scail_tpu.') or "
        "m in ('jaxlib', 'flax', 'ml_dtypes', 'tensorflow')]\n"
        "assert not bad, bad[:5]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
