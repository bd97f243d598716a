"""Gradient compression, the elastic checks and fault tolerance: the port
against the reference on the same inputs, on the CPU.

- ``compress_grads``/``decompress_grads`` with error feedback over 50
  steps of seeded gradients: quantized payloads, scales, residuals and
  dequantized gradients bitwise equal to the reference's at every step
  (both compute in f32, and ``torch.round`` rounds half to even as
  ``jnp.round`` does, checked on exact halves);
- ``validate_specs``: the same trees and specs pass or raise the same
  ``ValueError`` in both packages, before any copy;
- ``Supervisor``, ``HeartbeatMonitor`` and ``StragglerDetector``: the
  same fed sequences, with ``now`` injected, give the same restarts,
  histories, dead hosts and flagged hosts (``test_optim_ckpt_ft.py``'s
  cases, run through both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import manager as r_ckpt
from repro.checkpoint.elastic import validate_specs as r_validate
from repro.ft import failures as RF
from repro.ft import stragglers as RS
from repro.optim import compression as RC

from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.checkpoint.elastic import reshard, validate_specs as t_validate
from repro_torch.ft import failures as TF
from repro_torch.ft import stragglers as TS
from repro_torch.launch.collectives import P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compression as TC
from repro_torch.optim.tree import tree_leaves


def grads_at(step):
    rng = np.random.default_rng(100 + step)
    scale = 10.0 ** rng.uniform(-4, 1)
    return {"w": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
            "b": {"bias": (rng.standard_cauchy(size=(8,)) * scale).astype(np.float32),
                  "zero": np.zeros((3,), np.float32)}}


def test_round_half_to_even_in_both_packages():
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    want = np.array([-2.0, -2.0, -0.0, 0.0, 2.0, 2.0, 4.0], np.float32)
    assert np.array_equal(np.asarray(jnp.round(halves)), want)
    assert np.array_equal(torch.round(torch.from_numpy(halves)).numpy(), want)


def test_compression_with_error_feedback_bitwise_over_50_steps():
    r_ef = RC.init_error_feedback(jax.tree.map(jnp.asarray, grads_at(0)))
    t_ef = TC.init_error_feedback({"w": torch.zeros(16, 8),
                                   "b": {"bias": torch.zeros(8), "zero": torch.zeros(3)}})
    for step in range(50):
        g = grads_at(step)
        (rq, rs), r_ef = RC.compress_grads(jax.tree.map(jnp.asarray, g), r_ef)
        (tq, ts), t_ef = TC.compress_grads(
            {"w": torch.from_numpy(g["w"]), "b": {k: torch.from_numpy(v)
                                                  for k, v in g["b"].items()}}, t_ef)
        r_deq = RC.decompress_grads(rq, rs)
        t_deq = TC.decompress_grads(tq, ts)
        for r_tree, t_tree, dtype in ((rq, tq, torch.int8), (rs, ts, torch.float32),
                                      (r_ef.err, t_ef.err, torch.float32),
                                      (r_deq, t_deq, torch.float32)):
            for r_leaf, t_leaf in zip(jax.tree.leaves(r_tree), tree_leaves(t_tree)):
                assert t_leaf.dtype == dtype
                want = np.asarray(r_leaf).reshape(-1)
                assert np.array_equal(t_leaf.numpy().reshape(-1).view(np.uint8),
                                      want.view(np.uint8)), step


class FakeMesh:
    shape = {"data": 2}


@pytest.mark.parametrize("rows,spec_names,ok", [
    (8, ("data", None), True), (7, ("data", None), False), (6, (None,), True),
    (6, (("data",), None), True), (5, (("data",), None), False)])
def test_validate_specs_matches_reference(rows, spec_names, ok):
    tree = {"w": np.zeros((rows, 4)), "b": np.zeros(3)}
    r_specs, t_specs = {"w": JP(*spec_names), "b": None}, {"w": P(*spec_names), "b": None}
    outcomes = []
    for validate, specs in ((r_validate, r_specs), (t_validate, t_specs)):
        try:
            validate(tree, specs, FakeMesh())
            outcomes.append(None)
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == ok


def test_reshard_validates_then_places_blocks():
    mesh = make_host_mesh((2,), ("data",))
    with pytest.raises(ValueError, match="not divisible"):
        reshard({"w": np.zeros((8, 4)), "v": np.zeros((7, 2))},
                {"w": P("data", None), "v": P("data")}, mesh)
    placed = reshard({"w": np.arange(8.0).reshape(4, 2)}, {"w": P("data", None)}, mesh)
    assert [p.tolist() for p in placed["w"]] == [[[0.0, 1.0], [2.0, 3.0]],
                                                 [[4.0, 5.0], [6.0, 7.0]]]


# -- fault tolerance ------------------------------------------------------------
def detector_run(S, times):
    rebalanced, evicted, flagged = [], [], []
    det = S.StragglerDetector(4, S.StragglerConfig(window=8, persist_steps=2),
                              on_rebalance=rebalanced.append, on_evict=evicted.append)
    for row in times:
        for h, sec in enumerate(row):
            det.record_step(h, sec)
        flagged.append(det.check())
    return rebalanced, evicted, flagged, det.evicted


@pytest.mark.parametrize("pattern", ["one_slow", "uniform", "noisy_two_slow"])
def test_straggler_detector_matches_reference(pattern):
    rng = np.random.default_rng(3)
    if pattern == "one_slow":
        times = [[1.0 + (5.0 if h == 2 else 0.0) for h in range(4)] for _ in range(10)]
    elif pattern == "uniform":
        times = [[5.0] * 4 for _ in range(10)]
    else:
        times = [[float(1.0 + rng.exponential(0.02) + (0.5 if h in (1, 3) and s > 4 else 0))
                  for h in range(4)] for s in range(30)]
    got, want = detector_run(TS, times), detector_run(RS, times)
    assert got == want
    if pattern == "one_slow":
        assert got[0] == [2] and got[1] == [2]
    if pattern == "uniform":
        assert all(f == [] for f in got[2])


def supervisor_run(F, ckpt, root):
    tree = {"w": np.zeros(4)}
    attempts = []

    def train_fn(attempt):
        start = ckpt.latest_step(root)
        start = -1 if start is None else start
        attempts.append((attempt, start))
        for step in range(start + 1, 10):
            ckpt.save(root, step, tree)
            if attempt < 2 and step == 3 * (attempt + 1):
                raise F.WorkerFailure(host=attempt)
        return "done"

    sup = F.Supervisor(max_restarts=5)
    return sup.run(train_fn), attempts, sup.history


def test_supervisor_restarts_match_reference(tmp_path):
    got = supervisor_run(TF, t_ckpt, tmp_path / "port")
    want = supervisor_run(RF, r_ckpt, tmp_path / "ref")
    assert got == want
    assert got[1][1][1] == 3 and got[1][2][1] == 6 and len(got[2]) == 3


def test_supervisor_gives_up_as_the_reference():
    messages = []
    for F in (TF, RF):
        sup = F.Supervisor(max_restarts=1)

        def always_fail(attempt):
            raise F.WorkerFailure(host=attempt)

        with pytest.raises(RuntimeError) as exc:
            sup.run(always_fail)
        messages.append((str(exc.value), sup.history))
    assert messages[0] == messages[1]


def test_heartbeat_monitor_matches_reference():
    beats = [(0, 100.0), (1, 105.0), (2, 106.5), (0, 111.0), (3, 118.0)]
    probes = [107.0, 112.0, 116.4, 116.6, 120.0, 130.0]
    answers = []
    for F in (TF, RF):
        mon = F.HeartbeatMonitor(timeout_s=10)
        out = []
        for (host, now), probe in zip(beats + [(None, None)], probes):
            if host is not None:
                mon.beat(host, now=now)
            out.append(mon.dead_hosts(now=probe))
        answers.append(out)
    assert answers[0] == answers[1] == [[], [0], [0, 1], [1, 2], [1, 2], [0, 1, 2, 3]]
